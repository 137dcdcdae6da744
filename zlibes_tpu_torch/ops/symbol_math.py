"""Arithmetic DEFLATE value -> symbol / extra-bit maps, as torch ops.

Counterpart of ``zlibes_tpu/ops/symbol_math.py``.  The RFC 1951 length and
distance code tables follow a geometric pattern, so each map is a handful of
integer ops on a tensor of any shape and integer dtype; results are int64.
"""
from __future__ import annotations

import torch


def _bitlen(x: torch.Tensor, kmax: int = 15) -> torch.Tensor:
    """floor(log2(x)) + 1 for 1 <= x < 2**(kmax+1), saturating at kmax + 1
    above that (``kmax`` dense compares, as in the reference)."""
    x = x.long()
    n = torch.ones_like(x)
    for k in range(1, kmax + 1):
        n += (x >= (1 << k)).long()
    return n


def dist_symbol(dist: torch.Tensor) -> torch.Tensor:
    """Distance (1..32768) -> dist symbol (0..29)."""
    d1 = dist.long().clamp(min=1) - 1
    k = (_bitlen(d1.clamp(min=1)) - 2).clamp(min=0)
    high = 2 * (k + 1) + ((d1 >> k) & 1)
    return torch.where(dist <= 4, d1, high)


def dist_extra(dist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(extra bit count, extra bit value) for a distance."""
    d1 = dist.long().clamp(min=1) - 1
    k = torch.where(dist <= 4, 0, (_bitlen(d1.clamp(min=1)) - 2).clamp(min=0))
    base1 = torch.where(dist <= 4, d1, (2 + ((d1 >> k) & 1)) << k)
    return k, d1 - base1


def len_symbol(length: torch.Tensor) -> torch.Tensor:
    """Match length (3..258) -> litlen symbol (257..285)."""
    m = (length.long() - 3).clamp(0, 255)
    e = (_bitlen(m.clamp(min=1)) - 3).clamp(min=0)
    high = 257 + 4 * (e + 1) + ((m >> e) & 3)
    sym = torch.where(m < 8, 257 + m, high)
    return torch.where(length >= 258, 285, sym)


def len_extra(length: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(extra bit count, extra bit value) for a match length."""
    m = (length.long() - 3).clamp(0, 255)
    e = torch.where(m < 8, 0, (_bitlen(m.clamp(min=1)) - 3).clamp(min=0))
    base_m = torch.where(m < 8, m, (4 + ((m >> e) & 3)) << e)
    en = torch.where(length >= 258, 0, e)
    ev = torch.where(length >= 258, 0, m - base_m)
    return en, ev
