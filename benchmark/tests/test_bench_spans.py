"""The metrics that read the program's named spans (``harness/spans.py``):
the span arithmetic on hand-made intervals; each metric reads a value in
the traced CPU run of every cell it lists, and nothing from a trace
without its spans; and the four-rank cell ``blockpar4.compress`` as
``BENCHMARK.json`` has it, correct on a gloo world of four and not correct
with the exchange between ranks left out."""
import json
from types import SimpleNamespace

import pytest
import torch

from benchlib import ROOT, run_cpu, tiny_copy
from harness import spans
from harness.spec import reader
from zlibes_tpu_torch.parallel import block_parallel as bp

torch.set_num_threads(2)

# rank 0 of a four-rank run is this process, and the fault ``no_exchange``
# replaces these two in it for good: each run here starts from the real ones
EXCHANGE = {"_all_reduce": bp._all_reduce, "_all_gather": bp._all_gather}

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in SPEC["per_layer"]
                if m["source"] == "program_span"
                and m["name"] != "host_ms.deflate"]


def _trace(**iv):
    return SimpleNamespace(spans={f"zlibes.{k}": v for k, v in iv.items()})


def test_host_time_counts_a_nested_span_of_its_name_once():
    t = _trace(readback=[(0.0, 10.0), (2.0, 4.0), (20.0, 25.0)])
    assert spans.host_s(t, "zlibes.readback") == pytest.approx(15e-6)
    assert spans.host_s(t, "zlibes.plan") is None
    assert spans.host_s(None, "zlibes.plan") is None


def test_self_time_leaves_out_the_named_children():
    t = _trace(plan=[(0.0, 100.0), (200.0, 260.0)],
               upload=[(10.0, 30.0), (20.0, 40.0), (210.0, 220.0),
                       (500.0, 600.0)],
               readback=[(90.0, 100.0)])
    got = spans.self_s(t, "zlibes.plan", ("zlibes.upload", "zlibes.readback"))
    assert got == pytest.approx((160.0 - 30.0 - 10.0 - 10.0) / 1e6)
    assert spans.self_s(t, "zlibes.plan", ()) == pytest.approx(160e-6)
    assert spans.self_s(t, "zlibes.subindex", ("zlibes.upload",)) is None


def test_the_span_metrics_are_the_seven():
    assert sorted(m["name"] for m in SPAN_METRICS) == sorted([
        "plan_ms.inflate", "upload_ms.inflate", "subindex_ms.range",
        "plan_ms.range", "upload_ms.range", "wait_ms.deflate",
        "collective_wait_ms.deflate"])


@pytest.mark.parametrize("m", SPAN_METRICS, ids=lambda m: m["name"])
def test_a_trace_without_the_spans_reads_nothing(m):
    op = SimpleNamespace(work=lambda: {"bytes_in": 1 << 20,
                                       "bytes_out": 1 << 20, "reads": 10})
    for trace in (None, _trace()):
        assert reader(ROOT / "benchmark", m["name"])(
            SimpleNamespace(op=op, trace=trace)) is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


ONE_CHIP = ["zlib6.compress", "turbo.decompress", "zlib6.range"]


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_each_span_metric_reads_in_the_traced_run_of_its_cells(tiny, cell):
    res = run_cpu(tiny, cell, trace=True)
    assert res["correct"], res["checks"]
    mine = [m["name"] for m in SPAN_METRICS if cell in m["workloads"]]
    assert mine
    for name in mine:
        assert res["metrics"][name]["value"] > 0, name


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_ranks_as_the_benchmark_has_them(tiny, fault, monkeypatch):
    for name, fn in EXCHANGE.items():
        monkeypatch.setattr(bp, name, fn)
    kw = {"fault": fault} if fault else {}
    res = run_cpu(tiny, "blockpar4.compress", seconds=1.0,
                  trace=fault is None, **kw)
    assert res["device"]["count"] == 4
    assert res["correct"] == (fault is None), res["checks"]
    if fault is None:
        for name in ("wait_ms.deflate", "collective_wait_ms.deflate"):
            assert res["metrics"][name]["value"] > 0, name
        # the CPU holds no device record: no device metric is written
        assert "collective_ms.deflate" not in res["metrics"]
        assert "idle_share.deflate" not in res["metrics"]
