"""Adler-32 of a uint8 tensor, on the tensor's device.

Counterpart of ``adler32_device`` (``zlibes_tpu/ops/adler32.py:80``), as
plain torch ops.  Adler-32 splits into per-chunk partials: for a chunk at
byte offset o with digits d_j (j local),

    s1 += sum(d_j)
    s2 += (n - o) * sum(d_j) - sum(j * d_j)          (mod 65521)

so the checksum is two reductions over (chunks, CHUNK) plus a combine over
chunks, accumulated in int64.  The combine is a sum, so chunks held by
different ranks combine by summing each rank's partials
(``adler_partials``) and finishing once (``adler_value``): the shard
combine of ``zlibes_tpu/parallel/block_parallel.py:88-110, 147-156``, whose
int32-safe ``_modsum`` / ``_mulmod`` int64 makes unnecessary.
"""
from __future__ import annotations

import torch

from ..spec.constants import ADLER_MOD

_CHUNK = 4096


def adler32_device(data: torch.Tensor) -> torch.Tensor:
    """Adler-32 of the 1-D uint8 tensor ``data``; returns a 0-d int64
    tensor on ``data``'s device."""
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError("adler32_device takes a 1-D uint8 tensor")
    n = data.numel()
    d = torch.nn.functional.pad(data, (0, (-n) % _CHUNK))
    d = d.view(-1, _CHUNK).int()
    j = torch.arange(_CHUNK, dtype=torch.int32, device=data.device)
    a_c = d.sum(1)                      # int64: sum of digits per chunk
    b_c = (d * j).sum(1)                # < 255 * 4096^2 / 2 per chunk
    offs = torch.arange(a_c.numel(), dtype=torch.int64,
                        device=data.device) * _CHUNK
    return adler_value(*adler_partials(a_c, b_c, offs, n), n)


def adler_partials(a_c: torch.Tensor, b_c: torch.Tensor, offs: torch.Tensor,
                   n_total) -> tuple[torch.Tensor, torch.Tensor]:
    """(s1, s2) partials, mod 65521, of chunks with digit sums ``a_c``,
    weighted sums ``b_c`` (sum of j * d_j, j local) and first byte at
    ``offs`` of an input of ``n_total`` bytes, summed over the last axis
    (int64 tensors or numpy arrays; ``n_total`` an int or an array that
    broadcasts).  Partials of disjoint chunks add up, mod 65521, to those
    of their union."""
    s1 = a_c.sum(-1) % ADLER_MOD
    s2 = (((n_total - offs) % ADLER_MOD) * (a_c % ADLER_MOD)
          - b_c % ADLER_MOD).sum(-1) % ADLER_MOD
    return s1, s2


def adler_value(s1p, s2p, n_total):
    """The Adler-32 of ``n_total`` bytes from the (s1, s2) partials of all
    its chunks (ints or int64 tensors)."""
    return (((n_total + s2p) % ADLER_MOD) << 16) | ((1 + s1p) % ADLER_MOD)
