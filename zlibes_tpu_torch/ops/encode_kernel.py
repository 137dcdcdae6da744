"""Encode-side field kernel for NVIDIA Hopper, with its plain version.

Counterpart of ``zlibes_tpu/ops/encode_kernel.py``.  ``encode_fields``
turns each token into its combined coded field, LSB-first: litlen code,
length extra bits, dist code, dist extra bits, and the field's bit count.

A field has up to 48 bits (a 15-bit litlen code, 5 length-extra bits, a
15-bit dist code, 13 dist-extra bits); it stays within 32 bits only under
the turbo profile's 9-bit codes, far-match cap and 4 KiB window.  The
reference's kernel keeps the low 32 bits and drops the rest, so the
shared-table encode it feeds writes wrong bytes wherever a token is wider.
Here ``val`` is int64 and holds the whole field; its low 32 bits are the
reference's ``val`` for every token.

Replaces encode_fields (zlibes_tpu/ops/encode_kernel.py:110, kernel
_encfields_kernel :52).  The TPU kernel serves the table lookups with
banked vreg gathers from sublane-replicated (256, 384) table tiles.  On the
card it is one thread per token (``csrc/encode_kernels.cu``): the 288 + 32
packed table entries sit in shared memory, symbols and extra bits are
integer arithmetic, and each thread reads 12 B and writes 12 B.  It is
bound by that memory traffic, ~24 B a token.

The wrapper launches the kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; any other device raises.  Launches count
in ``turbo_kernel.LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..spec import constants as C

from .symbol_math import dist_extra, dist_symbol, len_extra, len_symbol
from .turbo_kernel import _check, _launch, _ptr, _route


def pack_tables(ll_code, ll_len, d_code, d_len) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Shared (code, length) tables -> packed ``code | len << 16`` int32
    rows (288,) and (32,), zero-padded; inputs are the 1-D numpy arrays of
    the stream's one table pair."""
    def pack(code, ln, n):
        row = np.zeros(n, np.int64)
        row[:len(code)] = (np.asarray(code, np.int64)
                           | (np.asarray(ln, np.int64) << 16))
        return torch.from_numpy(row.astype(np.int32))

    return (pack(ll_code, ll_len, C.NUM_LITLEN_SYMBOLS),
            pack(d_code, d_len, C.NUM_DIST_SYMBOLS))


def encode_fields_plain(tv, td, en, lt, dt):
    tv = tv.long()
    td = td.long()
    en = en > 0
    ism = en & (td > 0)
    lsym = torch.where(ism, len_symbol(tv.clamp(3, 258)), tv.clamp(0, 287))
    dsym = torch.where(ism, dist_symbol(td.clamp(1, 32768)), 0)
    e1 = lt.long()[lsym]
    code1 = e1 & 0x7FFF                 # not masked by ``en``, as reference
    n1 = torch.where(en, (e1 >> 16) & 31, 0)
    le_n, le_v = len_extra(tv)
    len_en = torch.where(ism, le_n, 0)
    len_ev = torch.where(ism, le_v, 0)
    e3 = dt.long()[dsym]
    code3 = torch.where(ism, e3 & 0x7FFF, 0)
    n3 = torch.where(ism, (e3 >> 16) & 31, 0)
    de_n, de_v = dist_extra(td)
    dist_en = torch.where(ism, de_n, 0)
    dist_ev = torch.where(ism, de_v, 0)
    n12 = n1 + len_en
    n123 = n12 + n3
    val = code1 | (len_ev << n1) | (code3 << n12) | (dist_ev << n123)
    return val, (n123 + dist_en).int()


def encode_fields(tv: torch.Tensor, td: torch.Tensor, en: torch.Tensor,
                  lt: torch.Tensor, dt: torch.Tensor):
    """tv, td (n,) int32 token values and distances (0 for a literal),
    en (n,) int32 validity, lt (288,) / dt (32,) int32 packed
    ``code | len << 16`` (lengths of at most 15 bits) -> (val (n,) int64,
    the whole coded field, below bit 48; nb (n,) int32 its bit count, 0
    where not ``en``).  Where ``en`` is 0, ``val`` holds the litlen table's
    code for ``tv`` clamped to 0..287, as the reference's does; the low 32
    bits of ``val`` equal the reference kernel's int32 ``val`` (taken as
    unsigned) on every token."""
    dev = tv.device
    n = tv.numel()
    for name, t, m in (("tv", tv, n), ("td", td, n), ("en", en, n),
                       ("lt", lt, C.NUM_LITLEN_SYMBOLS),
                       ("dt", dt, C.NUM_DIST_SYMBOLS)):
        _check(t, name, torch.int32, (m,), dev)
    if not _route(tv):
        return encode_fields_plain(tv, td, en, lt, dt)
    val = torch.empty(n, dtype=torch.int64, device=dev)
    nb = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("encode_fields", dev, _ptr(tv), _ptr(td), _ptr(en), _ptr(lt),
                _ptr(dt), ctypes.c_int64(n), _ptr(val), _ptr(nb))
    return val, nb
