"""What the port's named stage spans cost its calls, with no profiler
running and with one.

    python3 tools/probe_span_cost.py [--pairs N] [--reads N]

For the call of each of the benchmark's cells (``benchmark/``): the
level-6 ``deflate(with_index=True)`` of the bench corpus
(``zlibes_tpu_torch.bench_corpus``, 3,843,200 B), ``parallel_deflate`` of
it in a world of one, ``inflate_to_device`` of the turbo fixture
(``tests/golden/turbo_bench.*``) and ``inflate_range`` of 1 B-256 KiB
(log-uniform, seeded) from the wide fixture (``tests/golden/wide_bench.*``),
it times calls with the spans as they are (``config.trace``) and with every
module's ``trace``, ``config``'s own too, replaced by a no-op, in pairs whose side that runs first
alternates, all in one process and on one card: ``N`` pairs a call
(default 10; ``--reads`` pairs of range reads, default 400), first with no
profiler running, then inside one ``torch.profiler`` session (CPU and CUDA
activities).  Prints first what entering and leaving one span costs the
host either way, then for each call and mode the spans a call, the median
call of each side by the host clock, and the median of the pairs'
differences, also as a share of the median call without spans.  Every line
ends with the card's name and power limit.  Imports the port alone; needs
a card and ``nvcc``, exits non-zero without.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def _noop(name, *args, **kw):
    return contextlib.nullcontext()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reads", type=int, default=400)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_span_cost: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import zlibes_tpu_torch as zt
    from zlibes_tpu_torch import config
    from zlibes_tpu_torch.bench_corpus import bench_data
    from zlibes_tpu_torch.codec import deflate_pipeline, inflate_pipeline
    from zlibes_tpu_torch.codec import turbo, wide
    from zlibes_tpu_torch.parallel import batch, block_parallel

    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    card = f"[{smi.strip()}]"
    # config's own ``trace`` is the one the ``@span`` roots call
    modules = (config, deflate_pipeline, inflate_pipeline, turbo, wide,
               block_parallel, batch)
    real = config.trace

    def spans_on(on: bool) -> None:
        for m in modules:
            m.trace = real if on else _noop

    def span_us(n: int = 10000) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with config.trace("zlibes.match"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    print(f"one span entered and left: no profiler {span_us():.2f} us; "
          f"under torch.profiler ", end="")
    with profile(activities=[ProfilerActivity.CPU]):
        print(f"{span_us(2000):.2f} us, mean of 10,000 / 2,000 (host CPU "
              f"beside {card})")

    corpus = bench_data()
    golden = ROOT / "tests" / "golden"
    streams = {name: ((golden / f"{name}.zz").read_bytes(),
                      zt.StreamIndex.load(golden / f"{name}.idx.npz"))
               for name in ("turbo_bench", "wide_bench")}
    mesh = zt.parallel.make_mesh(1, device="cuda")
    rng = np.random.default_rng(17)
    wc, wi = streams["wide_bench"]
    total = wi.total_out
    lengths = np.exp(rng.uniform(0.0, np.log(1 << 18), args.reads)).astype(
        np.int64)
    starts = rng.integers(0, total, args.reads)
    reads = [(int(s), int(max(1, min(n, total - s))))
             for s, n in zip(starts, lengths)]

    def sync(fn):
        def call(i):
            out = fn(i)
            torch.cuda.synchronize()
            return out
        return call

    tc, ti = streams["turbo_bench"]
    calls = {
        "deflate_indexed level 6 of the corpus": (sync(
            lambda i: deflate_pipeline.deflate(corpus, with_index=True,
                                               device="cuda")), args.pairs),
        "parallel_deflate of the corpus, world of one": (sync(
            lambda i: zt.parallel.parallel_deflate(corpus, mesh)),
            args.pairs),
        "inflate_to_device of turbo_bench": (sync(
            lambda i: zt.inflate_to_device(tc, ti, device="cuda")),
            args.pairs * 5),
        "inflate_range of 1 B-256 KiB from wide_bench": (
            lambda i: zt.inflate_range(wc, wi, *reads[i % len(reads)],
                                       device="cuda"), args.reads),
    }

    def measure(fn, pairs: int) -> dict:
        ms = {"on": [], "off": []}
        for i in range(pairs):
            for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
                spans_on(side == "on")
                t0 = time.perf_counter()
                fn(i)
                ms[side].append((time.perf_counter() - t0) * 1e3)
        spans_on(True)
        return ms

    for what, (fn, pairs) in calls.items():
        fn(0)
        fn(1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn(0)
        count = collections.Counter(
            e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("zlibes."))
        for mode in ("no profiler", "torch.profiler on"):
            ctx = (profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
                   if mode != "no profiler" else contextlib.nullcontext())
            with ctx:
                ms = measure(fn, pairs)
            diff = statistics.median(a - b for a, b in zip(ms["on"],
                                                            ms["off"]))
            off = statistics.median(ms["off"])
            print(f"{what}, {mode}, {pairs} pairs, "
                  f"{sum(count.values())} spans a call: with spans "
                  f"{statistics.median(ms['on']):.4f} ms, without "
                  f"{off:.4f} ms (medians, host clock); the pairs' median "
                  f"difference {diff * 1e3:.1f} us, {diff / off * 100:.3f}% "
                  f"of the call {card}")
        print(f"  spans of one call: {dict(sorted(count.items()))}")


if __name__ == "__main__":
    main()
