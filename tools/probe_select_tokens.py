"""Time variants of the ``select_tokens`` kernel on real dispatches.

    python3 tools/probe_select_tokens.py [--seed N]

Builds ``tools/probe_select_tokens.cu`` with ``nvcc`` into
``build/probe_select_tokens/``, once for each entry of ``SOURCES``: a copy
of the port's ``zlibes_tpu_torch/csrc/encode_kernels.cu`` with some text
replaced (raising if the text is not there), which the probe's source
includes, so each library holds that copy's ``zt_select_tokens`` beside the
probe's own kernels: the first design (one thread walking the chain),
pointer doubling over the successors (mark words by ``atomicOr``, or a
byte a mark), a warp's speculative walk with a serial fix-up or a parallel
one without memory of earlier walks, and two parts that are not exact by
design (the token pass with the store of a one-token chain; the pass
alone).  The ``phase clocks`` copy records ``clock64()`` at the committed
kernel's phase boundaries; after each dispatch the probe prints, per
phase, the median and largest SM cycles a block, and the fix-up rounds.

The dispatches are the general encoder's at level 6
(``CodecConfig.from_level(6)``): the bench corpus' first dispatch
(``zlibes_tpu_torch.bench_corpus``, 16 blocks of 128 KiB, 512 lanes of
4,096 positions); the same blocks with every match taken away (all
literals); 1 MiB from ``numpy.random.default_rng(seed)`` through the
matcher (8 blocks, nearly all literals, 256 of 512 lanes empty); the bench
dispatch in lanes of 16,384 positions; and every position a match of 3
(the parse from one position never meets its neighbours').  Every exact
variant is held against ``select_tokens_plain`` on each dispatch, then 30
launches back to back are timed with CUDA events, best of 3, in three turns
that take the variants in order, so that they share a card.  Each
dispatch's line gives its longest and mean lane in tokens and the rounds
doubling takes on its longest lane (ceil(log2 count)).  Every line ends
with the card's name and power limit.  Imports the port alone; needs a
card and ``nvcc``, exits non-zero without.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "tools" / "probe_select_tokens.cu"
OUT = ROOT / "build" / "probe_select_tokens"

_KERNEL = """template <bool kSplitFar>
__global__ void __launch_bounds__(kTokThreads)
select_tokens_kernel("""
# clock64() of thread 0 at each phase boundary, and the fix-up rounds
_PHASES = [
    ("#include <cuda_runtime.h>",
     "#include <cuda_runtime.h>\n#define ZP_PHASES 1"),
    (_KERNEL, """__device__ long long zp_phase[1 << 16];
#define PHASE(i) \\
  if (threadIdx.x == 0) zp_phase[blockIdx.x * 8 + (i)] = clock64()
""" + _KERNEL),
    ("  const int P = 1 << lg_piece;\n",
     "  const int P = 1 << lg_piece;\n  PHASE(0);\n"),
    ("""    fbits[w] = 0;
  }
  __syncthreads();
""", """    fbits[w] = 0;
  }
  __syncthreads();
  PHASE(1);
"""),
    ("    int entry = __shfl_up_sync(0xffffffffu, out, 1);\n",
     "    int entry = __shfl_up_sync(0xffffffffu, out, 1);\n    PHASE(2);\n"
     "    int zp_rounds = 0;\n"),
    ("    for (;;) {  // (3)\n", "    for (;;) {  // (3)\n      ++zp_rounds;\n"),
    ("    uint16_t* fr = s_from[p];  // (4)\n",
     "    PHASE(3);\n"
     "    if (tid == 0) zp_phase[blockIdx.x * 8 + 7] = zp_rounds;\n"
     "    uint16_t* fr = s_from[p];  // (4)\n"),
    ("""  __syncthreads();
  // a thread a word""", """  __syncthreads();
  PHASE(4);
  // a thread a word"""),
    ("""  __syncthreads();

  store_marked(sbits, tok, seg, seg_len, tv + (int64_t)lane * seg,
               td + (int64_t)lane * seg, counts + lane);
}""", """  __syncthreads();
  PHASE(5);
  store_marked(sbits, tok, seg, seg_len, tv + (int64_t)lane * seg,
               td + (int64_t)lane * seg, counts + lane);
  __syncthreads();
  PHASE(6);
}"""),
]
PHASE_NAMES = ("token pass", "speculative walk", "fix-up rounds", "chain",
               "marks", "rank + store")

# source copy -> substitutions (old, new) in encode_kernels.cu
SOURCES = {"as committed": [], "phase clocks": _PHASES}
# label -> (source copy, launcher)
VARIANTS = {
    "committed": ("as committed", "zt_select_tokens"),
    "walk (first design)": ("as committed", "zp_select_tokens_walk"),
    "doubling": ("as committed", "zp_select_tokens_doubling"),
    "doubling, byte marks": ("as committed", "zp_select_tokens_dbytes"),
    "spec, serial fix-up": ("as committed", "zp_select_tokens_spec"),
    "spec, parallel fix-up": ("as committed", "zp_select_tokens_jacobi"),
    "committed, phase clocks": ("phase clocks", "zt_select_tokens"),
    "part: pass + store": ("as committed", "zp_select_tokens_floor"),
    "part: pass": ("as committed", "zp_select_tokens_pass"),
}
# variants that time a part of the kernel and are not exact by design
PARTS = tuple(v for v in VARIANTS if v.startswith("part:"))


def build() -> dict:
    """Source copy name -> its loaded library, all built at once."""
    from zlibes_tpu_torch.runtime import kernels

    text = (ROOT / "zlibes_tpu_torch" / "csrc" / "encode_kernels.cu"
            ).read_text()
    procs = {}
    for name, subs in SOURCES.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in "
                                 "encode_kernels.cu")
            src = src.replace(old, new)
        d = OUT / "".join(c if c.isalnum() else "_" for c in name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "encode_kernels.cu").write_text(src)
        so = d / "libprobe_select_tokens.so"
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", f"-I{d}",
             "-o", str(so), str(SRC)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_select_tokens: nvcc failed on {name}\n"
                             f"{out}")
        libs[name] = ctypes.CDLL(str(so))
    for source, fn_name in VARIANTS.values():
        fn = getattr(libs[source], fn_name)
        fn.argtypes = kernels._SIGNATURES["zt_select_tokens"]
        fn.restype = ctypes.c_int
    return libs


def phase_report(lib, live: np.ndarray, smi: str) -> None:
    """SM cycles a block of each phase of the phase clocks copy's last
    launch: median and largest over the ``live`` lanes."""
    L = live.size
    raw = (ctypes.c_longlong * (8 * L))()
    fn = lib.zp_read_phases
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    if fn(ctypes.cast(raw, ctypes.c_void_p), 8 * L):
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    t = np.frombuffer(raw, np.int64).reshape(L, 8)
    d = np.diff(t[:, :7], axis=1)
    parts = ", ".join(
        f"{n} {int(np.median(d[live, i]))} / {int(d[live, i].max())}"
        for i, n in enumerate(PHASE_NAMES))
    print(f"  phases, SM cycles a block, median / largest over "
          f"{int(live.sum())} lanes: {parts}; fix-up rounds median "
          f"{int(np.median(t[live, 7]))}, most {int(t[live, 7].max())} "
          f"[{smi}]", flush=True)


def dispatches(seed: int) -> dict:
    """name -> (data, matches, n_valid, SEG_SIZE) on the card."""
    from zlibes_tpu_torch import CodecConfig
    from zlibes_tpu_torch.bench_corpus import bench_data
    from zlibes_tpu_torch.codec.framing import stage_rows
    from zlibes_tpu_torch.ops.lz77 import find_matches

    cfg = CodecConfig.from_level(6)
    N, Bp = cfg.block_size, cfg.blocks_per_dispatch

    def rows(arr: np.ndarray):
        nblocks = -(-arr.size // N)
        blk, nv = stage_rows(arr, 0, min(Bp, nblocks), N, Bp)
        blk = torch.from_numpy(blk).cuda()
        nv = torch.from_numpy(nv).cuda()
        return blk, find_matches(blk, nv, N=N, S=cfg.probe_words,
                                 J=cfg.candidates), nv

    blk, matches, nv = rows(np.frombuffer(bench_data(), np.uint8))
    rnd = np.random.default_rng(seed).integers(0, 256, 1 << 20, np.uint8)
    r_blk, r_matches, r_nv = rows(rnd)
    return {
        "bench dispatch": (blk, matches, nv, cfg.seg_size),
        "all literals": (blk, torch.zeros_like(matches), nv, cfg.seg_size),
        "1 MiB random": (r_blk, r_matches, r_nv, cfg.seg_size),
        "bench, SEG 16384": (blk, matches, nv, 16384),
        "period 3": (blk, torch.full_like(matches, (3 << 16) | 3), nv,
                     cfg.seg_size),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_select_tokens: torch.cuda.is_available() is "
                         "false")
    sys.path.insert(0, str(ROOT))
    from zlibes_tpu_torch.ops import lz77

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    libs = build()
    stream = torch.cuda.current_stream().cuda_stream
    failed = False
    for name, (data, matches, nv, seg) in dispatches(args.seed).items():
        B, N = matches.shape
        L = B * (N // seg)
        tv_p, td_p, cnt_p = lz77.select_tokens_plain(data, matches, nv, N,
                                                     seg)
        longest = int(cnt_p.max())
        print(f"{name}: {L} lanes of {seg}, {int(cnt_p.sum())} tokens, "
              f"longest lane {longest}, mean "
              f"{float(cnt_p.float().mean()):.1f}, {int((cnt_p == 0).sum())} "
              f"empty; doubling rounds of the longest lane "
              f"{math.ceil(math.log2(longest)) if longest > 1 else 0} "
              f"[{smi}]", flush=True)
        tv = torch.empty((L, seg), dtype=torch.int32, device="cuda")
        td = torch.empty_like(tv)
        cnt = torch.empty(L, dtype=torch.int32, device="cuda")

        def launch(fn) -> None:
            rc = fn(data.data_ptr(), data.shape[1], matches.data_ptr(),
                    nv.data_ptr(), N, N // seg, seg, 0, 1, 0, L, tv.data_ptr(),
                    td.data_ptr(), cnt.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        for variant, (source, fn_name) in VARIANTS.items():
            tv.fill_(-1)
            launch(getattr(libs[source], fn_name))
            torch.cuda.synchronize()
            exact = (torch.equal(cnt, cnt_p) and torch.equal(tv, tv_p)
                     and torch.equal(td, td_p))
            failed |= not exact and variant not in PARTS
            print(f"  {variant:24s} exact={exact}"
                  + (" (a part, not exact by design)" if variant in PARTS
                     else ""), flush=True)
        for turn in range(3):
            for variant, (source, fn_name) in VARIANTS.items():
                fn = getattr(libs[source], fn_name)
                best = []
                for _ in range(3):
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    for _ in range(30):
                        launch(fn)
                    t1.record()
                    torch.cuda.synchronize()
                    best.append(t0.elapsed_time(t1) / 30)
                print(f"  turn {turn} {variant:24s} {min(best):.4f} ms a "
                      f"launch (30 back to back, best of 3) [{smi}]",
                      flush=True)
        launch(libs["phase clocks"].zt_select_tokens)
        torch.cuda.synchronize()
        phase_report(libs["phase clocks"], cnt_p.cpu().numpy() > 0, smi)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
