"""Whole runs of the cells on the CPU at a tiny size, the card's check
skipped: a sound run comes out correct; the control and every fault the
cell can have come out not correct; and a cell made of new files and a new
entry alone is found and runs."""
import json

import pytest
import torch

from benchlib import SEED, run_cpu, tiny_copy

torch.set_num_threads(2)

ONE_CHIP = ["zlib6.compress", "turbo.decompress", "zlib6.range"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_a_sound_run_is_correct(tiny, cell):
    res = run_cpu(tiny, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert all(c["limit"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_the_traced_run_is_correct(tiny, cell):
    res = run_cpu(tiny, cell, trace=True)
    assert res["correct"], res["checks"]
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run holds no device record: no device metric is written
    assert not any(k.startswith(("idle_share", "match_ms", "glue_ms"))
                   for k in res["metrics"])


@pytest.mark.parametrize("cell", ONE_CHIP)
@pytest.mark.parametrize("fault", ["flip", "half", "stale", "control"])
def test_faults_and_the_control_are_caught(tiny, cell, fault):
    kw = {"control": True} if fault == "control" else {"fault": fault}
    # the warm-up's answer is the first stale one
    res = run_cpu(tiny, cell, seconds=3.0 if fault == "stale" else 1.0, **kw)
    assert not res["correct"], res["checks"]


@pytest.fixture(scope="module")
def tiny4(tiny):
    """The tiny copy with the four-rank cell ``blockpar4.compress`` added:
    its configuration file is in ``benchmark/configs``, its entries here."""
    spec = json.loads(tiny.read_text())
    spec["configs"].append({"name": "blockpar4", "source": "pigz",
                            "file": "benchmark/configs/blockpar4.json",
                            "reduced": [], "why": "four ranks"})
    spec["workloads"].append({"name": "blockpar4.compress",
                              "config": "blockpar4",
                              "traffic": "compress_files", "chips": 4,
                              "why": "four ranks"})
    for m in spec["end_to_end"]:
        if m["name"] in ("deflate_gbps", "stored_ratio"):
            m["workloads"].append("blockpar4.compress")
    spec["per_layer"].append({"name": "collective_ms.deflate",
                              "unit": "ms/MiB", "better": "lower",
                              "source": "device_trace", "layer": "parallel",
                              "moves": "deflate_gbps",
                              "workloads": ["blockpar4.compress"]})
    out = tiny.parent / "BENCHMARK4.json"
    out.write_text(json.dumps(spec))
    return out


@pytest.mark.parametrize("fault", [None, "no_exchange", "control"])
def test_four_ranks(tiny4, fault):
    kw = ({"control": True} if fault == "control"
          else {"fault": fault} if fault else {})
    res = run_cpu(tiny4, "blockpar4.compress", seconds=1.0, **kw)
    assert res["device"]["count"] == 4
    assert res["correct"] == (fault is None), res["checks"]


def test_a_cell_of_new_files_and_a_new_entry_runs(tiny):
    root = tiny.parent
    bench = root / "benchmark"
    # a new configuration, a new traffic mix and a new per-layer metric,
    # each a new file; one new entry of each kind in BENCHMARK.json
    cfg = json.loads((bench / "configs" / "zlib6.json").read_text())
    cfg["encoder"] = {"api": "level1_indexed"}
    cfg["level"] = 1
    # an encoder entry the harness does not have: a new file under apis/
    (bench / "apis").mkdir(exist_ok=True)
    (bench / "apis" / "level1_indexed.py").write_text(
        "import dataclasses\n"
        "import zlibes_tpu_torch as zt\n"
        "from zlibes_tpu_torch.codec import deflate_pipeline\n\n\n"
        "def make(settings, device, mesh):\n"
        "    cfg = dataclasses.replace(zt.CodecConfig.from_level(1),\n"
        "                              blocks_per_dispatch=2)\n"
        "    return lambda data: deflate_pipeline.deflate(\n"
        "        data, with_index=True, config=cfg, device=device)\n")
    (bench / "configs" / "zlib1.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "compress_two.json").write_text(json.dumps(
        {"op": "compress_logged", "files": ["a", "b"],
         "order": "seeded_cycle"}))
    # an op the harness does not have: a new file under ops/
    (bench / "ops").mkdir(exist_ok=True)
    (bench / "ops" / "compress_logged.py").write_text(
        "from harness.ops import Compress\n\n\n"
        "class Op(Compress):\n"
        "    def record(self, item, result, t0, t1):\n"
        "        super().record(item, result, t0, t1)\n"
        "        self.logged = getattr(self, 'logged', 0) + 1\n")
    (bench / "metrics" / "calls.deflate.py").write_text(
        "def read(run):\n    return run.op.logged\n")
    spec = json.loads(tiny.read_text())
    spec["configs"].append({"name": "zlib1", "source": "https://zlib.net/",
                            "file": "benchmark/configs/zlib1.json",
                            "reduced": [], "why": "level 1"})
    spec["workloads"].append({"name": "zlib1.compress_two",
                              "config": "zlib1", "traffic": "compress_two",
                              "chips": 1, "why": "two files at level 1"})
    for m in spec["end_to_end"]:
        if m["name"] in ("deflate_gbps", "stored_ratio"):
            m["workloads"].append("zlib1.compress_two")
    spec["per_layer"].append({"name": "calls.deflate", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "API", "moves": "deflate_gbps",
                              "workloads": ["zlib1.compress_two"]})
    new = root / "BENCHMARK.json"
    new.write_text(json.dumps(spec))
    res = run_cpu(new, "zlib1.compress_two")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"deflate_gbps", "stored_ratio", "setup_s"}
    res = run_cpu(new, "zlib1.compress_two", trace=True, seed=SEED + 1)
    assert res["correct"] and res["metrics"]["calls.deflate"]["value"] >= 1
