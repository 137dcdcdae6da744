"""Cost probes for a serial per-lane walk on an NVIDIA Hopper card.

    python3 tools/probe_hopper.py

Builds ``tools/probe_hopper.cu`` with ``nvcc`` for ``sm_90a`` into
``build/probe_hopper/`` and prints, in SM cycles per operation: a dependent
shared-memory lookup; the same lookup in global memory through L1 and
through L2; a dependent and an independent integer instruction of
one warp that is alone on its scheduler or shares it with 1, 3 or 7 busy
warps; the funnel-shift / select step that moves a 96-bit stream view on;
and 32 scattered lane windows staged by ``cp.async`` and read from shared
memory against the same dependent reads made straight from global memory.
These are the quantities the decode kernels of ``zlibes_tpu_torch/csrc``
were designed around (the answer on this card to what
``tools/probe_pallas*.py`` measure for the TPU kernels).  Every line ends
with the card's name and power limit.  Imports neither codec package;
exits non-zero without a card or without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "tools" / "probe_hopper.cu"
BUILD = ROOT / "build" / "probe_hopper"


def build() -> ctypes.CDLL:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = next((str(c) for c in (Path(cuda_home) / "bin" / "nvcc",
                                  shutil.which("nvcc"))
                 if c and Path(c).is_file()), None)
    if nvcc is None:
        raise SystemExit("probe_hopper: nvcc not found")
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / "libprobe_hopper.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-o", str(so), str(SRC)], check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (("probe_smem_chain", [I, P, P]),
                           ("probe_global_chain", [I, P, I, P, P]),
                           ("probe_alu", [I, I, I, P, P]),
                           ("probe_refill", [I, I, P, P]),
                           ("probe_gather", [I, P, P, I, I, I, P, P])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, I
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_hopper: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    card = f"[{smi}]"
    lib = build()
    cycles = torch.zeros(2, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")

    def call(fn, *args) -> list[int]:
        best = None
        for _ in range(3):     # the first run also warms the caches
            rc = fn(*args, cycles.data_ptr(), sink.data_ptr())
            if rc != 0:
                raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")
            got = cycles.tolist()
            best = got if best is None else [min(a, b)
                                             for a, b in zip(best, got)]
        return best

    iters = 4096
    c = call(lib.probe_smem_chain, iters)[0]
    print(f"smem_chain: {c / iters:.1f} cycles a dependent shared-memory "
          f"lookup (one warp, {iters} lookups) {card}")
    i = torch.arange(2048, device="cuda")
    table = ((i * 5 + 1 + 64 * (i & 31)) & 2047).int()
    for l1, path in ((1, "L1 (__ldg)"), (0, "L2 (ld.global.cg)")):
        c = call(lib.probe_global_chain, l1, table.data_ptr(), iters)[0]
        print(f"global_chain: {c / iters:.1f} cycles a dependent lookup in "
              f"an 8 KB table in global memory through {path} (one warp, "
              f"{iters} lookups) {card}")
    for warps in (4, 8, 16, 32):
        dep = call(lib.probe_alu, warps, 1, iters)[0] / (3 * iters)
        ind = call(lib.probe_alu, warps, 4, iters)[0] / (12 * iters)
        print(f"alu: {warps // 4} warp(s) a scheduler: {dep:.2f} cycles a "
              f"dependent integer instruction, {ind:.2f} an independent one "
              f"(per warp; xor, shift, add) {card}")
    for width in (32, 96):
        c = call(lib.probe_refill, iters, width)[0]
        print(f"refill: {c / iters:.1f} cycles a funnel-shift / select step "
              f"of a lone warp, rows of {width} words {card}")
    # a stream of 1.5 MB; lane windows start ~12 words apart, as on level-6
    # data, so neighbouring windows overlap
    words = torch.randint(-2**31, 2**31 - 1, (400_000,), device="cuda",
                          dtype=torch.int64).int()
    blocks = 960
    start_w = (torch.arange(blocks * 32, device="cuda") * 12).int()
    reads = 256
    for width in (32, 96):
        st = call(lib.probe_gather, 1, words.data_ptr(), start_w.data_ptr(),
                  blocks, width, reads)
        di = call(lib.probe_gather, 0, words.data_ptr(), start_w.data_ptr(),
                  blocks, width, reads)
        print(f"gather: 32 windows of {width} words, {blocks} blocks: staged "
              f"by cp.async in {st[0]} cycles a block, then "
              f"{st[1] / reads:.1f} cycles a dependent read from shared "
              f"memory; direct from global memory {di[1] / reads:.1f} cycles "
              f"a dependent read {card}")


if __name__ == "__main__":
    sys.exit(main())
