"""What the encoder's named stage spans cost a whole ``deflate()`` call.

    python3 tools/probe_span_cost.py [--pairs N]

Encodes the bench corpus (``zlibes_tpu_torch.bench_corpus``, 3,843,200 B)
on the card in the turbo profile and at level 6, ``N`` pairs of calls each
(default 10), one call with the spans on (``deflate_pipeline.trace``, the
default) and one with each span replaced by a no-op, the side that runs
first alternating from pair to pair, all in one process and on one card.
Prints first what entering and leaving one span costs the host, then for
each encode the median whole call of each side by the host clock, the
quartile spread of the side without spans and the pairs in which the call
with spans was the slower.  Every line ends with the card's
name and power limit.  Imports the port alone; needs a card and ``nvcc``,
exits non-zero without.
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    pairs = ap.parse_args().pairs
    if not torch.cuda.is_available():
        raise SystemExit("probe_span_cost: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import zlibes_tpu_torch as zt
    from zlibes_tpu_torch.bench_corpus import bench_data
    from zlibes_tpu_torch.codec import deflate_pipeline as dp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    card = f"[{smi.strip()}]"
    corpus = bench_data()
    with_spans = dp.trace
    sides = {"on": with_spans, "off": lambda name: contextlib.nullcontext()}
    for side, fn in sides.items():
        t0 = time.perf_counter()
        for _ in range(10000):
            with fn("zlibes.match"):
                pass
        print(f"one span entered and left, spans {side}: "
              f"{(time.perf_counter() - t0) / 10000 * 1e6:.2f} us, mean of "
              f"10,000 (host CPU beside {card})")
    for what, kw in (("turbo", dict(config=zt.CodecConfig.turbo())),
                     ("level 6", dict(level=6))):
        want = zt.deflate(corpus, device="cuda", **kw)
        ms = {"on": [], "off": []}
        for i in range(pairs):
            for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
                dp.trace = sides[side]
                t0 = time.perf_counter()
                out = zt.deflate(corpus, device="cuda", **kw)
                ms[side].append((time.perf_counter() - t0) * 1e3)
                assert out == want, f"{what}: the bytes changed"
        dp.trace = with_spans
        q = statistics.quantiles(ms["off"], n=4)
        slower = sum(a > b for a, b in zip(ms["on"], ms["off"]))
        print(f"{what} deflate() of {len(corpus)} B, {pairs} pairs: spans on "
              f"{statistics.median(ms['on']):.2f} ms, off "
              f"{statistics.median(ms['off']):.2f} ms (median, host clock); "
              f"spread of off (Q3 - Q1) {q[2] - q[0]:.2f} ms; on slower in "
              f"{slower} of {pairs} pairs {card}")


if __name__ == "__main__":
    main()
