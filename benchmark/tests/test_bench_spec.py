"""``BENCHMARK.json`` keeps the benchmark's rules: names, units and keys,
every metric's reader, every per-layer metric's ``moves`` and
``workloads``, and the files each cell finds by name."""
import ast
import json

import pytest

from harness import spec

from benchlib import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_keys_are_valid():
    assert spec.problems(SPEC, ROOT) == []
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_per_layer_metric_has_moves_and_workloads():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        # each cell of the metric reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_every_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        f = BENCH / "metrics" / f"{m['name']}.py"
        assert f.is_file(), f
        tree = ast.parse(f.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in tree.body), f


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = spec.load_cell(ROOT / "BENCHMARK.json", cell)
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert c.traffic["op"] in ("compress", "decompress", "range")
    assert c.chips == c.config["chips"]


def test_paths_command_and_chips():
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    cells = SPEC["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    # a full check of 24 cells fits its time: 2 + 14 runs a cell
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
