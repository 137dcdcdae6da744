"""The shared-table configs outside the turbo profile and the buffers that
take their coded tokens past 32 bits, for the CPU tests, the card tests,
``chip_smoke.py`` and ``tools/make_torch_fixture.py --shared``.

Imports the port alone (no JAX), so the card tests can use it.

  * ``shared_full``     ``CodecConfig(seg_size=512, shared_tables=True)``:
                        ``select_tokens`` on 512-byte lanes, no window
                        reset, 15-bit codes: tokens of up to 48 bits;
  * ``shared_turbo15``  ``CodecConfig.turbo()`` with 15-bit codes:
                        ``select_turbo`` with ``split_far`` off, 4 KiB
                        reset: tokens of up to 15 + 1 + 15 + 10 bits (the
                        probe cap of 16 bytes keeps length extras at 1);
  * ``shared_seg1024``  ``CodecConfig(seg_size=1024, chunk_reset=4096,
                        shared_tables=True, max_code_bits=9)``:
                        ``select_tokens`` with ``split_far`` on; 9-bit
                        codes, the far cap and the 4 KiB reset keep every
                        token within 32 bits.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

import zlibes_tpu_torch
from zlibes_tpu_torch.ops import deflate_kernel as dk
from zlibes_tpu_torch.spec import constants as C
from zlibes_tpu_torch.spec import refmodel

SHARED_CONFIGS = {
    "shared_full": zlibes_tpu_torch.CodecConfig(seg_size=512,
                                                shared_tables=True),
    "shared_turbo15": dataclasses.replace(zlibes_tpu_torch.CodecConfig.turbo(),
                                          max_code_bits=15),
    "shared_seg1024": zlibes_tpu_torch.CodecConfig(
        seg_size=1024, chunk_reset=4096, shared_tables=True,
        max_code_bits=9),
}


def skewed_data(seed: int = 0, n: int = 65536) -> bytes:
    """16 literals at 0.9 (the other 240 at 0.1) and 200-257-byte copies
    from more than 16 KiB back: long codes and far matches, which take a
    coded token past 32 bits."""
    rng = np.random.default_rng(seed)
    common = rng.choice(256, 16, replace=False)
    rare = np.setdiff1d(np.arange(256), common)
    out = np.empty(n, np.uint8)
    pick = rng.random(n) < 0.9
    out[pick] = rng.choice(common, pick.sum())
    out[~pick] = rng.choice(rare, (~pick).sum())
    pos = 20000
    while pos < n - 300:
        ln = int(rng.integers(200, 258))
        src = pos - int(rng.integers(16385, 20000))
        out[pos : pos + ln] = out[src : src + ln]
        pos += ln + int(rng.integers(200, 1500))
    return out.tobytes()


def far_copy_data(seed: int = 0, n: int = 65536) -> bytes:
    """Random bytes and, inside each 4 KiB chunk, short copies whose
    lengths (3-13) and distance classes (1-48 bytes) fall off
    geometrically, so that the rarest length and distance symbols get long
    codes; and one 16-byte copy from 3,841-4,070 bytes back, a rare token
    of both its length symbol (267) and its distance symbol (23, 10 extra
    bits, the top two of them set).  Under ``shared_turbo15`` that token's
    field passes 32 bits although the 4 KiB reset and the 16-byte probe
    cap keep its extra bits at 1 + 10, and the reference's 32-bit field
    loses set bits of it."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, n, dtype=np.uint8)
    lens = np.repeat([3, 4, 5, 6, 7, 8, 9, 10, 11, 13],
                     [1024 >> k for k in range(10)])
    dcls = np.repeat(np.arange(11), [1024 >> k for k in range(11)])
    dcls = dcls[:lens.size]
    rng.shuffle(lens)
    rng.shuffle(dcls)
    dist = [int(rng.integers(C.DIST_BASE[c],
                             C.DIST_BASE[c] + (1 << C.DIST_EXTRA_BITS[c])))
            for c in dcls]
    copies = list(zip(lens.tolist(), dist))
    nch = n // 4096
    per = -(-len(copies) // nch)
    for ci in range(nch):
        c0 = ci * 4096
        mine = copies[ci * per:(ci + 1) * per]
        far = ci == 5
        p = c0 + 200
        gap = (c0 + (3500 if far else 4076) - p) // max(len(mine), 1)
        for ln, d in mine:
            out[p:p + ln] = out[p - d:p - d + ln]
            p += gap
        if far:
            q = c0 + 4070
            d = int(rng.integers(3841, 4071))
            out[q:q + 16] = out[q - d:q - d + 16]
    return out.tobytes()


def deep_tables():
    """(litlen, dist) code lengths with 15-bit codes for length symbol 284
    (227-257 bytes) and distance symbols 28-29 (16,385-32,768):
    frequencies that halve symbol by symbol make the deepest trees
    package-merge allows.  Tokens of those symbols code to 48 bits."""
    llf = np.zeros(C.NUM_LITLEN_SYMBOLS, np.int64)
    llf[:256] = 1000
    llf[257:286] = [1 << max(0, 20 - i) for i in range(29)]
    llf[256] = llf[284] = 1
    df = np.zeros(C.NUM_DIST_SYMBOLS, np.int64)
    df[:30] = [1 << max(0, 24 - k) for k in range(30)]
    df[28] = df[29] = 1
    return (refmodel.package_merge_lengths(llf, 15),
            refmodel.package_merge_lengths(df, 15))


@contextlib.contextmanager
def widest_token():
    """Within the block, every ``encode_fields`` call the shared-table pack
    makes records the widest coded token it reports: yields a list whose
    one item is that bit count (0 before any call)."""
    widest = [0]
    real = dk.encode_fields

    def spy(tv, td, en, lt, dt):
        val, nb = real(tv, td, en, lt, dt)
        if nb.numel():
            widest[0] = max(widest[0], int(nb.max()))
        return val, nb

    dk.encode_fields = spy
    try:
        yield widest
    finally:
        dk.encode_fields = real
