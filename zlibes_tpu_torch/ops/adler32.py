"""Adler-32 of a uint8 tensor, on the tensor's device.

Counterpart of ``adler32_device`` (``zlibes_tpu/ops/adler32.py:80``), as
plain torch ops.  Adler-32 splits into per-chunk partials: for a chunk at
byte offset o with digits d_j (j local),

    s1 += sum(d_j)
    s2 += (n - o) * sum(d_j) - sum(j * d_j)          (mod 65521)

so the checksum is two reductions over (chunks, CHUNK) plus a combine over
chunks, accumulated in int64.
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
    terms = ((n - offs) % ADLER_MOD) * (a_c % ADLER_MOD) - b_c % ADLER_MOD
    s1 = (1 + a_c.sum()) % ADLER_MOD
    s2 = (n + terms.sum()) % ADLER_MOD
    return (s2 << 16) | s1
