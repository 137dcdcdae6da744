"""Time variants of the ``decode_tokens`` kernel on a generic group.

    python3 tools/probe_decode_tokens.py

The group is the bench corpus (``zlibes_tpu_torch.bench_corpus``) through
CPython zlib at level 6 with a full flush every 32 KiB, indexed by the
port's ``build_index``: 940 lanes of about 4 KiB, one group, as
``chip_smoke.py`` drives it.  For each variant the script rewrites a piece
of ``zlibes_tpu_torch/csrc/inflate_kernels.cu`` (the questions its design
turns on: the block's first row staged in shared memory against every row
read through L1 from the flattened scratch, the stream's words loaded a
step ahead or in the step, the lookups' addresses worked out from the row
or from an opaque row pointer, 1 to 32 lanes a block against as few as make
two blocks an SM),
raising if the text a variant rewrites is not there, builds the copy with
``nvcc`` into
``build/probe_decode_tokens/``, holds the kernel exactly against
``decode_tokens_plain`` and times 30 launches back to back with CUDA events.
Variants are timed in turns, three times, inside one process, so they share
a card.  Every line ends with the card's name and power limit.  A new idea
is one more entry of ``VARIANTS``.  Needs a card and ``nvcc``; exits
non-zero without.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "zlibes_tpu_torch" / "csrc"
OUT = ROOT / "build" / "probe_decode_tokens"
NVCC = "/usr/local/cuda/bin/nvcc"

# the flat row of the block's first lane in shared memory, copied by the
# warp with 16-byte cp.async before the walk (the lanes of that row read it
# there, the others through L1): rows staged against rows flattened once a
# call into scratch
_STAGED = [
    ("""  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int64_t row = min(max(table_row[l], 0), nrows - 1);
""", """  __shared__ __align__(16) int32_t s_flat[kFlatW];
  const int l = blockIdx.x * kDecodeLanes + threadIdx.x;
  const int64_t row0 =
      min(max(table_row[blockIdx.x * kDecodeLanes], 0), nrows - 1);
  for (int i = threadIdx.x; i < kFlatW / 4; i += kDecodeLanes)
    cp_async16(s_flat + 4 * i, flat + row0 * kFlatW + 4 * i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (l >= lanes) return;
  const int64_t row = min(max(table_row[l], 0), nrows - 1);
"""),
    ("const int32_t* lf = flat + row * kFlatW;",
     "const int32_t* lf = row == row0 ? s_flat : flat + row * kFlatW;"),
    ("return __ldg(lf + (x & (kLlFast - 1)));",
     "return lf[x & (kLlFast - 1)];"),
    ("return __ldg(lf + kLlFast + (y & (kDFast - 1)));",
     "return lf[kLlFast + (y & (kDFast - 1))];"),
]

# no word loaded a step ahead: p0 loads its word in the step that takes it
_LOAD_IN_STEP = [
    ("r1 = r2; r2 = r3; r3 = p0; p0 = ahead;",
     "r1 = r2; r2 = r3; r3 = p0; p0 = word(wq);"),
    ("""      ahead = word(wq);
      x0 = nx0;""", """      x0 = nx0;"""),
]


# the row's flat roots and the lane's words behind pointers the compiler
# cannot take apart, so that a lookup's address is one 32-bit index scaled
# onto a 64-bit base instead of the row's offset worked out again
_OPAQUE = [
    ("const int32_t* lf = flat + row * kFlatW;  // the row's flat roots",
     """const int32_t* lf = flat + row * kFlatW;  // the row's flat roots
  asm("" : "+l"(lf));"""),
    ("const uint32_t* wp = words + w0;",
     """const uint32_t* wp = words + w0;
    asm("" : "+l"(wp));"""),
]


def _lanes(n: int):
    """n lanes a block, in place of as few as fill the schedulers once."""
    return [("const int lpb = decode_lanes_a_block(lanes);",
             f"const int lpb = {n};")]


# name -> substitutions in inflate_kernels.cu
VARIANTS = {
    "as committed": [],
    "first row staged": _STAGED + _lanes(32),
    "no word loaded ahead": _LOAD_IN_STEP,
    "opaque row pointers": _OPAQUE,
    "1 lane a block": _lanes(1),
    "2 lanes a block": _lanes(2),
    "8 lanes a block": _lanes(8),
    "32 lanes a block": _lanes(32),
}


def start_build(name: str, subs) -> tuple[subprocess.Popen, Path]:
    text = (SRC / "inflate_kernels.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} is not in inflate_kernels.cu")
        text = text.replace(old, new)
    stem = "".join(c if c.isalnum() else "_" for c in name)
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
        raise SystemExit("probe_decode_tokens: torch.cuda.is_available() is "
                         "false")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_contract_cases import zlib_flushed

    import zlibes_tpu_torch
    from zlibes_tpu_torch.bench_corpus import bench_data
    from zlibes_tpu_torch.codec import inflate_pipeline as ip
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    builds = {name: start_build(name, subs)
              for name, subs in VARIANTS.items()}

    comp = zlib_flushed(bench_data(), 32768)
    index = zlibes_tpu_torch.build_index(comp)
    (p,) = ip.plan_groups(comp, index, "cuda")
    words = ip._Stream(comp, "cuda").words
    lanes = (words, p.lt, p.dt, p.rows, p.bit0, p.endb, p.active)
    T, B = p.T, p.B
    want = ik.decode_tokens_plain(*lanes, T)
    emitted = (torch.arange(T, device="cuda")[:, None]
               < want[2][None, :].long())
    print(f"group: {B} lanes, T={T}, {int(want[2].sum())} tokens, longest "
          f"lane {int(want[2].max())} [{smi}]", flush=True)
    tokens = torch.empty((T, B), dtype=torch.int32, device="cuda")
    starts = torch.empty((T, B), dtype=torch.int32, device="cuda")
    count = torch.empty(B, dtype=torch.int32, device="cuda")
    bitpos = torch.empty(B, dtype=torch.int64, device="cuda")
    active = torch.empty(B, dtype=torch.bool, device="cuda")
    err = torch.empty(B, dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int

    flat = torch.empty((p.lt.shape[0], ik.FLAT_W), dtype=torch.int32,
                       device="cuda")

    def run(so: Path) -> tuple[bool, float]:
        fn = ctypes.CDLL(str(so)).zt_decode_tokens
        fn.argtypes = [P, ctypes.c_int64, P, P, I, P, P, P, P, P, I, I, P, P,
                       P, P, P, P, P]
        fn.restype = I

        def launch() -> None:
            rc = fn(words.data_ptr(), words.numel(), p.lt.data_ptr(),
                    p.dt.data_ptr(), p.lt.shape[0], flat.data_ptr(),
                    p.rows.data_ptr(), p.bit0.data_ptr(), p.endb.data_ptr(),
                    p.active.data_ptr(), B, T, tokens.data_ptr(),
                    starts.data_ptr(), count.data_ptr(), bitpos.data_ptr(),
                    active.data_ptr(), err.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        launch()
        torch.cuda.synchronize()
        exact = (torch.equal(count, want[2]) and torch.equal(bitpos, want[3])
                 and torch.equal(active, want[4])
                 and torch.equal(err, want[5])
                 and torch.equal(tokens[emitted], want[0][emitted])
                 and torch.equal(starts[emitted], want[1][emitted]))
        best = []
        for _ in range(3):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(30):
                launch()
            t1.record()
            torch.cuda.synchronize()
            best.append(t0.elapsed_time(t1) / 30)
        return exact, min(best)

    failed = False
    for name, (proc, _) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed = True
            print(f"{name}: build failed\n{out[-2000:]}")
    for turn in range(3):
        for name, (proc, so) in builds.items():
            if proc.returncode:
                continue
            exact, ms = run(so)
            failed |= not exact
            print(f"turn {turn} {name:24s} exact={exact} {ms:.4f} ms a "
                  f"launch (30 launches back to back, best of 3) [{smi}]",
                  flush=True)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
