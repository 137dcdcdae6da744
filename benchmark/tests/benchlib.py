"""Helpers of the benchmark's tests: a copy of the benchmark at a tiny size
that the CPU can run, and a run of one of its cells on the CPU."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SEED = 2**31 + 11
TINY_FILES = {"a": 70000, "b": 40000, "c": 100000}


def tiny_copy(dst: Path) -> Path:
    """``BENCHMARK.json`` and ``benchmark/`` under ``dst``, every
    configuration file cut to three small files and the port's dispatches to two
    blocks; returns the copy's ``BENCHMARK.json``."""
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for f in sorted((dst / "benchmark" / "configs").glob("*.json")):
        cfg = json.loads(f.read_text())
        cfg["files"] = dict(TINY_FILES)
        cfg["read_files"] = ["a", "c"]
        if cfg["encoder"]["api"] == "parallel_deflate":
            cfg["encoder"]["params"] = {"block_size": 16384}
        else:
            cfg["encoder"]["codec_config"] = {"blocks_per_dispatch": 2}
        f.write_text(json.dumps(cfg))
    out = dst / "BENCHMARK.json"
    out.write_text(json.dumps(spec))
    return out


def run_cpu(bench_json: Path, workload: str, seconds: float = 0.5,
            trace: bool = False, seed: int = SEED, **kw):
    """One run of ``workload`` on the CPU, the card's check skipped."""
    from harness import spec
    from harness.cell import run_cell
    from harness.ranks import run_ranks

    chips = spec.load_cell(bench_json, workload).chips
    t = time.perf_counter()
    if chips > 1:
        return run_ranks(chips, bench_json, workload, seed, seconds, trace,
                         "cpu", t, **kw)
    return run_cell(bench_json, workload, seed, seconds, trace,
                    torch.device("cpu"), t, **kw)
