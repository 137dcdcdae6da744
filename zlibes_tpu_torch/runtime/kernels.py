"""Build and load the port's CUDA kernels.

Counterpart of the build-once pattern of ``zlibes_tpu/runtime/native.py``:
at first use ``nvcc`` compiles each of the package's ``csrc/*.cu`` for
Hopper (``sm_90a``), all sources at once in parallel processes, and links
them into one shared library with a plain C interface, under
``build/zlibes_tpu_torch/`` beside the package, named by a hash of the
sources and the headers (``csrc/*.cuh``) they include; ``ctypes`` loads it.  A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "zlibes_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# launcher name -> argument types; every launcher ends with the stream and
# returns cudaGetLastError()
_SIGNATURES = {
    "zt_lane_windows": [_P, _I64, _P, _I64, _INT, _P, _P],
    "zt_decode_turbo": [_P, _I64, _P, _P, _P, _P, _P, _INT, _INT, _P, _P, _P],
    "zt_resolve_turbo": [_P, _P, _INT, _P, _P],
    "zt_decode_wide": [_P, _I64, _P, _INT, _P, _P, _P, _P, _P, _INT, _INT,
                       _INT, _P, _P, _P, _P],
    "zt_resolve_wide": [_P, _P, _INT, _INT, _P, _P, _P],
    "zt_wide_lanes": [_P, _P, _I64, _P, _INT, _INT, _P, _P, _P, _P, _P, _P],
    "zt_select_turbo": [_P, _P, _INT, _INT, _INT, _P, _P, _P],
    "zt_select_tokens": [_P, _I64, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT,
                         _INT, _P, _P, _P, _P],
    "zt_encode_fields": [_P, _P, _P, _P, _P, _I64, _P, _P, _P],
    "zt_block_tables": [_P, _P, _P, _INT, _INT, _INT, _P, _P, _P, _P, _P, _P,
                        _P],
    "zt_decode_tables": [_P, _I64, _I64, _P, _INT, _P, _P, _P, _P],
    "zt_decode_tokens": [_P, _I64, _P, _P, _INT, _P, _P, _P, _P, _P, _INT,
                         _INT, _P, _P, _P, _P, _P, _P, _P],
    "zt_resolve_global": [_P, _P, _P, _P, _INT, _INT, _P, _INT, _INT, _INT,
                          _P, _P, _P, _P, _P, _P],
}


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def headers() -> list[Path]:
    """The ``csrc/*.cuh`` that the sources include."""
    return sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libzlibes_tpu_torch-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sources()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(srcs, objs)]
        errors = []
        for src, proc in zip(srcs, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {src.name} failed ({proc.returncode}):"
                              f"\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        tmp.rename(so)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
