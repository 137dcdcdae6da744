"""The bench corpus: the bytes every measurement of the port compresses and
decompresses, and which the committed fixtures ``tests/golden/turbo_bench.*``
and ``tests/golden/wide_bench.*`` encode.

The same bytes as ``bench_data`` of ``tools/make_bench_fixture.py`` (which
``bench.py`` uses for the JAX package): the port keeps its own copy of the
recipe, so that nothing here imports that module.
"""
from __future__ import annotations

from pathlib import Path

RAW = Path(__file__).resolve().parent.parent / "tests" / "golden" / "raw.bin"


def bench_data(raw: bytes | None = None) -> bytes:
    """~3.8 MB of corpus-like data: eight rotated copies of ``raw`` (by
    default the checkout's ``tests/golden/raw.bin``).  Verbatim repetition
    would manufacture cross-copy back-reference chains that no real mixed
    corpus shows."""
    if raw is None:
        raw = RAW.read_bytes()
    return b"".join(raw[i * 60000:] + raw[: i * 60000] for i in range(8))
