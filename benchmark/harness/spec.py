"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each lives in a file of its
own (``configs/<name>.json``, ``traffic/<name>.json``), and each metric has a
reader of its own (``metrics/<name>.py``).  So a later cell, mix or metric
is new files and new entries, never an edit of a file that is there.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    workloads: list[str] | None = None
    bound: float | None = None
    layer: str | None = None
    moves: str | None = None


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[Metric]
    per_layer: list[Metric]
    bench_dir: Path = field(default=BENCH_DIR)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric(d: dict, end_to_end: bool) -> Metric:
    return Metric(d["name"], d["unit"], d["better"], d["source"], end_to_end,
                  d.get("workloads"), d.get("bound"), d.get("layer"),
                  d.get("moves"))


def _reports(m: Metric, cell: str, e2e_of_cell: set[str]) -> bool:
    if m.workloads is not None:
        return cell in m.workloads
    if m.end_to_end:
        return True
    return m.moves in e2e_of_cell


def load_cell(bench_json: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``bench_json``, with its configuration,
    traffic mix and the metrics it reports; KeyError for an unknown name."""
    spec = load_json(bench_json)
    root = bench_json.parent
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_json}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    config["name"] = w["config"]
    paths = [root / p for p in spec["paths"]]
    traffic = None
    for p in paths:
        f = p / "traffic" / f"{w['traffic']}.json"
        if f.is_file():
            traffic = load_json(f)
            break
    if traffic is None:
        raise KeyError(f"no traffic file {w['traffic']}.json under "
                       f"{spec['paths']}")
    traffic["name"] = w["traffic"]
    e2e = [_metric(m, True) for m in spec["end_to_end"]]
    e2e = [m for m in e2e if _reports(m, workload, set())]
    names = {m.name for m in e2e}
    layer = [_metric(m, False) for m in spec["per_layer"]]
    layer = [m for m in layer if _reports(m, workload, names)]
    return Cell(workload, config, traffic, int(w["chips"]), e2e, layer,
                paths[0])


def plugin(bench_dir: Path, kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder: a
    metric's reader (``metrics``), and a traffic op (``ops``) or an encoder
    entry (``apis``) that the harness does not have itself."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind}/{name}.py under {bench_dir}")
    key = re.sub(r"\W", "_", f"bench_{kind}_{name}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: Path, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return plugin(bench_dir, "metrics", metric).read


def problems(spec: dict, root: Path) -> list[str]:
    """What in ``spec`` (a parsed BENCHMARK.json) breaks the benchmark's
    rules of names, units and keys; empty when nothing does."""
    out = []

    def name_ok(what, v):
        if not isinstance(v, str) or not NAME_RE.match(v):
            out.append(f"{what}: bad name {v!r}")

    def line_ok(what, v):
        if (not isinstance(v, str) or not 1 <= len(v) <= 200 or "\n" in v
                or "\t" in v):
            out.append(f"{what}: bad text {v!r}")

    top = {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"}
    if set(spec) != top:
        out.append(f"top-level keys {sorted(spec)} != {sorted(top)}")
    for word in spec.get("command", []):
        line_ok("command", word)
    for c in spec.get("configs", []):
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c.get('name')}: keys {sorted(c)}")
        name_ok("config", c.get("name"))
        line_ok("config source", c.get("source"))
        line_ok("config why", c.get("why"))
        for k in c.get("reduced", []):
            name_ok("reduced", k)
        if not (root / c.get("file", "")).is_file():
            out.append(f"config {c.get('name')}: no file {c.get('file')}")
    names = set()
    for w in spec.get("workloads", []):
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload {w.get('name')}: keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            name_ok(f"workload {k}", w.get(k))
        line_ok("workload why", w.get("why"))
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips {w.get('chips')}")
        names.add(w.get("name"))
    metric_names = []
    for group, e2e in (("end_to_end", True), ("per_layer", False)):
        for m in spec.get(group, []):
            keys = ({"name", "unit", "better", "bound", "source"} if e2e else
                    {"name", "unit", "better", "source", "layer", "moves"})
            if set(m) - {"workloads"} != keys:
                out.append(f"metric {m.get('name')}: keys {sorted(m)}")
            name_ok("metric", m.get("name"))
            metric_names.append(m.get("name"))
            if not isinstance(m.get("unit"), str) or not UNIT_RE.match(
                    m["unit"]):
                out.append(f"metric {m.get('name')}: bad unit "
                           f"{m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                out.append(f"metric {m.get('name')}: better {m.get('better')}")
            if m.get("source") not in (SOURCES_E2E if e2e else SOURCES):
                out.append(f"metric {m.get('name')}: source {m.get('source')}")
            for w in m.get("workloads", []):
                if w not in names:
                    out.append(f"metric {m.get('name')}: no workload {w}")
            if not e2e:
                line_ok("layer", m.get("layer"))
    if len(set(metric_names)) != len(metric_names):
        out.append("two metrics share a name")
    return out
