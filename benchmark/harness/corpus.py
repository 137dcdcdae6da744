"""The seeded corpus: each file of a configuration is made of slices of
``benchmark/data/raw.bin`` (480,400 B of mixed text and binary data).

A file's slices have seeded lengths of 64-256 KiB and tile ``raw.bin`` read
as a ring, from a seeded offset on (wrapping around its end), until the
file has its configured size; then they are concatenated in a seeded order.
A slice is longer than DEFLATE's 32 KiB window, so no file repeats itself
inside one window.  Because the slices tile the ring, every seed's file
holds the corpus's text and binary parts in the same proportions, and so
compresses alike: the seed changes the bytes, their order and where the
slices meet, not the mix of work.  The same seed gives the same bytes;
every file of a run draws from its own stream of the seed.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

RAW = Path(__file__).resolve().parent.parent / "data" / "raw.bin"
RAW_SHA256 = "e61a1579eba2c6581598381cadc5c475c3ec1ddf01036388f221daa1e13eadfc"
SLICE_MIN = 64 * 1024
SLICE_MAX = 256 * 1024


def raw_corpus() -> np.ndarray:
    """``raw.bin`` as uint8, checked against its digest."""
    raw = RAW.read_bytes()
    if hashlib.sha256(raw).hexdigest() != RAW_SHA256:
        raise RuntimeError(f"{RAW} is not the corpus the benchmark was "
                           f"defined with")
    return np.frombuffer(raw, np.uint8)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any integer) and a stream number."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def make_file(raw: np.ndarray, size: int, seed: int, index: int) -> bytes:
    """``size`` bytes of seeded slices of ``raw`` (file ``index`` of the
    run)."""
    g = rng(seed, 1, index)
    ring = np.concatenate([raw, raw[:SLICE_MAX]])
    parts, have = [], 0
    off = int(g.integers(0, raw.size))
    while have < size:
        n = min(int(g.integers(SLICE_MIN, SLICE_MAX + 1)), size - have)
        parts.append(ring[off:off + n])
        off = (off + n) % raw.size
        have += n
    order = g.permutation(len(parts))
    return (np.concatenate([parts[k] for k in order]).tobytes() if parts
            else b"")
