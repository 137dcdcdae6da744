"""Time variants of the ``decode_wide`` kernel on the wide bench fixture.

    python3 tools/probe_decode_wide.py

For each variant it rewrites constants of
``zlibes_tpu_torch/csrc/wide_kernels.cu`` (bits of the flattened litlen and
distance roots, threads and lanes a block), builds the copy with ``nvcc``
into ``build/probe_decode_wide/``, holds the kernel exactly against
``decode_wide_plain`` on ``tests/golden/wide_bench.*`` and times 50 launches
back to back with CUDA events, at the fixture's ``T`` and at ``T = 0`` (the
walk skipped: launch, staging and the meta rows alone).  Variants are timed
in turns, twice, inside one process, so they share a card.  Every line ends
with the card's name and power limit.  This is how the builds of the kernel
were compared while it was designed; a new idea is one more entry of
``VARIANTS``.  Needs a card and ``nvcc``; exits non-zero without.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "zlibes_tpu_torch" / "csrc"
OUT = ROOT / "build" / "probe_decode_wide"
GOLDEN = ROOT / "tests" / "golden"
NVCC = "/usr/local/cuda/bin/nvcc"


def constant(name: str, old: int, new: int) -> tuple[str, str]:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


def bits(ll: int, d: int):
    return [constant("kLlFastBits", 11, ll), constant("kDFastBits", 8, d)]


# name -> substitutions in the source
VARIANTS = {
    "as committed": [],
    "roots 12 + 9 bits": bits(12, 9),
    "roots 10 + 7 bits": bits(10, 7),
    "roots 9 + 6 bits": bits(9, 6),
    "64 threads a block": [constant("kDecodeThreads", 128, 64)],
    "256 threads a block": [constant("kDecodeThreads", 128, 256)],
    "64 lanes a block": [constant("kDecodeLanes", 32, 64)],
    "128 lanes a block": [constant("kDecodeLanes", 32, 128)],
}


def start_build(name: str, subs) -> tuple[subprocess.Popen, Path]:
    text = (SRC / "wide_kernels.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} is not in wide_kernels.cu")
        text = text.replace(old, new)
    stem = name.replace(" ", "_").replace("+", "and")
    cu = OUT / f"{stem}.cu"
    cu.write_text(text)
    so = OUT / f"{stem}.so"
    proc = subprocess.Popen(
        [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", f"-I{SRC}", "-o", str(so),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, so


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_decode_wide: torch.cuda.is_available() is "
                         "false")
    sys.path.insert(0, str(ROOT))
    from zlibes_tpu_torch import StreamIndex
    from zlibes_tpu_torch.codec import wide as wd
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops import wide_kernel as wk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    builds = {name: start_build(name, subs)
              for name, subs in VARIANTS.items()}

    comp = (GOLDEN / "wide_bench.zz").read_bytes()
    index = StreamIndex.load(GOLDEN / "wide_bench.idx.npz")
    plan = wd.WidePlan.build(comp, index, "cuda")
    L, T = plan.Cb * plan.LPB, plan.T
    win = tk.lane_windows_plain(plan.words, plan.start_w, plan.SW)
    want = wk.decode_wide_plain(win, plan.bit0, plan.endb, plan.base,
                                plan.lt, plan.dt, plan.LPB)
    emitted = torch.arange(T, device="cuda")[:, None] < want[2][0][None, :]
    tokens = torch.zeros((T, L), dtype=torch.int32, device="cuda")
    starts = torch.zeros((T, L), dtype=torch.int32, device="cuda")
    meta = torch.zeros((6, L), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int

    def run(so: Path, t_run: int) -> tuple[bool, float]:
        fn = ctypes.CDLL(str(so)).zt_decode_wide
        fn.argtypes = [P, ctypes.c_int64, P, I, P, P, P, P, P, I, I, I, P, P,
                       P, P]
        fn.restype = I

        def launch() -> None:
            rc = fn(plan.words.data_ptr(), plan.words.numel(),
                    plan.start_w.data_ptr(), plan.SW, plan.bit0.data_ptr(),
                    plan.endb.data_ptr(), plan.base.data_ptr(),
                    plan.lt.data_ptr(), plan.dt.data_ptr(), L, plan.LPB,
                    t_run, tokens.data_ptr(), starts.data_ptr(),
                    meta.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        launch()
        torch.cuda.synchronize()
        exact = (t_run != T
                 or (torch.equal(meta, want[2])
                     and torch.equal(tokens[emitted], want[0][emitted])
                     and torch.equal(starts[emitted], want[1][emitted])))
        best = []
        for _ in range(3):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(50):
                launch()
            t1.record()
            torch.cuda.synchronize()
            best.append(t0.elapsed_time(t1) / 50)
        return exact, min(best)

    failed = False
    for name, (proc, _) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed = True
            print(f"{name}: build failed\n{out[-2000:]}")
    for turn in range(2):
        for name, (proc, so) in builds.items():
            if proc.returncode:
                continue
            exact, ms = run(so, T)
            _, ms0 = run(so, 0)
            failed |= not exact
            print(f"turn {turn} {name:22s} exact={exact} {ms:.4f} ms a "
                  f"launch, {ms0:.4f} ms at T=0 (50 launches back to back, "
                  f"best of 3) [{smi}]", flush=True)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
