"""Drive the PyTorch port's turbo inflate once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``zlibes_tpu_torch/csrc/``, holds each
kernel against its plain PyTorch version on the committed bench fixture
(``tests/golden/turbo_bench.*``: the 3.84 MB bench corpus in the turbo
profile), decodes the fixture through ``zlibes_tpu_torch.inflate(...,
device="cuda")`` with every kernel's launch count checked, times the
kernels and the pipeline with CUDA events, and probes corrupted streams.
Any failure raises.  The last line of standard output is one JSON object
naming the device; the line before it is the card's name and power limit
from nvidia-smi, and the line before that the per-kernel JSON record.
Imports no JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
TURBO_SRC = "zlibes_tpu/ops/turbo_kernel.py"


def cuda_ms(fn, runs: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def wall_s(fn, runs: int = 5) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_pipeline(fn, card: str, runs: int = 5) -> dict[str, float]:
    """Trace ``runs`` calls of ``fn`` with torch.profiler; print device time
    per kernel and the device's idle share of the traced window.  Returns
    mean device ms per call by kernel name (empty when the trace holds no
    device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        print("profiler: the trace holds no device activity; "
              "device times not measured")
        return {}
    per_name: dict[str, float] = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    for e in kern:
        per_name[e.name] = (per_name.get(e.name, 0.0)
                            + (e.time_range.end - e.time_range.start))
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    print(f"profiler ({runs} device-pipeline calls): device busy "
          f"{busy / runs / 1e3:.4f} ms per call, idle share "
          f"{1 - busy / window:.3f} of the {window / runs / 1e3:.4f} ms "
          f"per call between first and last kernel {card}")
    top = sorted(per_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:12]:
        print(f"  device {us / runs / 1e3:.4f} ms/call  {name[:100]}")
    return {name: us / runs / 1e3 for name, us in per_name.items()}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import zlibes_tpu_torch
    from tools.make_bench_fixture import bench_data
    from zlibes_tpu_torch import ChecksumError, CorruptError, StreamIndex
    from zlibes_tpu_torch.codec import turbo as tb
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops.adler32 import adler32_device
    from zlibes_tpu_torch.runtime import kernels

    # -- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    card = f"[{smi}]"

    # -- 2. build the kernels from the checkout's sources
    t0 = time.perf_counter()
    kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(str(s.relative_to(ROOT)) for s in kernels.sources())}"
          f" -> {kernels.library_path().relative_to(ROOT)})")

    # -- 3. the committed fixture and the corpus it encodes
    comp = (GOLDEN / "turbo_bench.zz").read_bytes()
    index = StreamIndex.load(GOLDEN / "turbo_bench.idx.npz")
    corpus = bench_data()
    assert index.turbo
    assert zlib.decompress(comp) == corpus, "fixture does not encode the corpus"
    plan = tb.TurboPlan.build(comp, index, "cuda")
    print(f"fixture: corpus {len(corpus)} B, stream {len(comp)} B, "
          f"{len(index.blocks)} blocks, L={plan.L} lanes (L_pad={plan.L_pad}), "
          f"C_pad={plan.C_pad} chunk rows")

    # -- 4. each kernel against its plain version, at the fixture's shapes
    records = {}
    win = tk.lane_windows(plan.words, plan.start_w)
    torch.cuda.synchronize()
    win_p = tk.lane_windows_plain(plan.words, plan.start_w)
    assert torch.equal(win, win_p), "lane_windows != plain"
    records["lane_windows"] = dict(
        replaces=f"{TURBO_SRC}:192,239", max_abs_err=max_abs_err(win, win_p),
        ms=cuda_ms(lambda: tk.lane_windows(plan.words, plan.start_w)),
        plain_ms=cuda_ms(lambda: tk.lane_windows_plain(plan.words,
                                                       plan.start_w),
                         runs=10),
        shape=list(win.shape))

    dec_args = (win, plan.bit0, plan.endb, plan.lt, plan.dt)
    tokens, meta = tk.decode_turbo(*dec_args)
    torch.cuda.synchronize()
    tokens_p, meta_p = tk.decode_turbo_plain(*dec_args)
    emitted = (torch.arange(plan.T, device="cuda")[:, None]
               < meta_p[0][None, :])
    assert torch.equal(meta, meta_p), "decode_turbo meta != plain"
    assert torch.equal(tokens[emitted], tokens_p[emitted]), \
        "decode_turbo tokens != plain"
    plan.check_meta(meta.cpu().numpy())
    records["decode_turbo"] = dict(
        replaces=f"{TURBO_SRC}:496",
        max_abs_err=max(max_abs_err(meta, meta_p),
                        max_abs_err(tokens[emitted], tokens_p[emitted])),
        ms=cuda_ms(lambda: tk.decode_turbo(*dec_args)),
        plain_ms=cuda_ms(lambda: tk.decode_turbo_plain(*dec_args), runs=10),
        shape=list(tokens.shape), tokens=int(meta[0].sum()))

    toks16, starts16 = tb._glue_tokens(tokens, meta[0], plan.base, plan.C_pad)
    rows = tk.resolve_turbo(toks16, starts16)
    torch.cuda.synchronize()
    rows_p = tk.resolve_turbo_plain(toks16, starts16)
    assert torch.equal(rows, rows_p), "resolve_turbo != plain"
    assert rows.reshape(-1)[: plan.total_out].cpu().numpy().tobytes() == corpus
    records["resolve_turbo"] = dict(
        replaces=f"{TURBO_SRC}:621", max_abs_err=max_abs_err(rows, rows_p),
        ms=cuda_ms(lambda: tk.resolve_turbo(toks16, starts16)),
        plain_ms=cuda_ms(lambda: tk.resolve_turbo_plain(toks16, starts16),
                         runs=10),
        shape=list(rows.shape))
    for name, r in records.items():
        print(f"kernel {name}: exact vs plain (max_abs_err {r['max_abs_err']}),"
              f" kernel {r['ms']:.4f} ms (median of 20), plain "
              f"{r['plain_ms']:.4f} ms (median of 10), "
              f"shape {r['shape']} {card}")
    glue_ms = cuda_ms(lambda: tb._glue_tokens(tokens, meta[0], plan.base,
                                              plan.C_pad))
    flat = rows.reshape(-1)[: plan.total_out]
    adler_ms = cuda_ms(lambda: adler32_device(flat))
    print(f"torch ops: glue {glue_ms:.4f} ms, adler32 {adler_ms:.4f} ms, "
          f"median of 20 {card}")

    # -- 5. end to end through the public entry point
    tk.LAUNCHES.clear()
    out = zlibes_tpu_torch.inflate(comp, index=index, device="cuda")
    launches = dict(tk.LAUNCHES)
    assert out == corpus, "inflate(device='cuda') output != corpus"
    print(f"inflate(device='cuda'): {len(out)} B byte-exact, "
          f"Adler-32 verified on the device; launches {launches}")
    for name in records:
        assert launches.get(name, 0) >= 1, f"{name} not launched by inflate"

    trailer = int.from_bytes(comp[-4:], "big")

    def device_pipeline():
        rows = tb.run_turbo(plan, check=False)
        return adler32_device(rows.reshape(-1)[: plan.total_out])

    assert int(device_pipeline()) == trailer
    pipe_ms = cuda_ms(device_pipeline)
    call_s = wall_s(lambda: zlibes_tpu_torch.inflate(comp, index=index,
                                                     device="cuda"))
    plan_s = wall_s(lambda: tb.TurboPlan.build(comp, index, "cuda"))
    zlib_s = wall_s(lambda: zlib.decompress(comp))
    n = len(corpus)
    print(f"host: TurboPlan.build (tables, lane spans, copies to the card) "
          f"{plan_s * 1e3:.2f} ms, median of 5 {card}")
    print(f"device pipeline (plan prebuilt, stream on device; windows + "
          f"decode + glue + resolve + adler32): {pipe_ms:.4f} ms -> "
          f"{n / pipe_ms / 1e6:.3f} GB/s of output, median of 20 {card}")
    print(f"whole inflate() call, host to host: {call_s * 1e3:.2f} ms -> "
          f"{n / call_s / 1e9:.3f} GB/s, median of 5 {card}")
    print(f"CPython zlib.decompress, one core: {zlib_s * 1e3:.2f} ms -> "
          f"{n / zlib_s / 1e9:.3f} GB/s, median of 5 (host CPU beside {card})")
    device_ms = profile_pipeline(device_pipeline, card)
    if device_ms:
        busy = sum(device_ms.values())
        print(f"untraced device pipeline: device busy {busy:.4f} of "
              f"{pipe_ms:.4f} ms -> idle share {1 - busy / pipe_ms:.3f} "
              f"(host launch-bound where high) {card}")

    # -- 6. corruption probe
    rng = np.random.default_rng(3)
    raised = 0
    for _ in range(6):
        bad = bytearray(comp)
        pos = int(rng.integers(16, len(bad) - 8))
        bad[pos] ^= int(rng.integers(1, 256))
        try:
            got = zlibes_tpu_torch.inflate(bytes(bad), index=index,
                                           device="cuda")
        except (CorruptError, ChecksumError) as exc:
            raised += 1
            print(f"corruption at byte {pos}: {type(exc).__name__}")
        else:
            assert got == corpus, f"flip at byte {pos} decoded to wrong bytes"
            print(f"corruption at byte {pos}: in a bit gap, output unchanged")
    assert raised >= 4, f"only {raised} of 6 corruptions detected"

    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "zlibes_tpu_torch/csrc/turbo_kernels.cu",
         "replaces": r["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"],
         "device_ms": next((v for k, v in device_ms.items()
                            if f"{name}_kernel" in k), None)}
        for name, r in records.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
