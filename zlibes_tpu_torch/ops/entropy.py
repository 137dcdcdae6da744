"""Length-limited Huffman code lengths on the device, as torch ops.

Counterpart of ``zlibes_tpu/ops/entropy.py``: the package-merge algorithm
in matrix form, histogram in, code lengths out, with no host round trip.
Package membership is tracked as count vectors; each merge round is a
pairwise add, a concatenation and a stable sort by weight (the same stable
order the reference's sort gives, so ties break alike).
"""
from __future__ import annotations

import torch

# inactive-slot weight; BIG + BIG = 2^30 never wraps int32 sums, and
# frequencies are clipped so real package weights stay below it
_BIG = 1 << 29


def package_merge_device(freqs: torch.Tensor, max_len: int) -> torch.Tensor:
    """Optimal length-limited code lengths (<= max_len) for one histogram
    (S,) -> (S,) int32.  Counts above 2^29 / 4S are clipped, as in the
    reference; one used symbol gets length 1."""
    S = freqs.numel()
    dev = freqs.device
    freqs = freqs.long().clamp(max=_BIG // (4 * S))
    used = freqs > 0
    n_active = used.sum()

    sw = torch.where(used, freqs, _BIG)
    order = torch.sort(sw, stable=True).indices
    sw_sorted = sw[order]
    eye = torch.eye(S, dtype=torch.long, device=dev)
    sm_sorted = torch.where(used[order][:, None], eye[order], 0)

    M = 2 * S
    pad_w = torch.full((M - S,), _BIG, dtype=torch.long, device=dev)
    pad_m = torch.zeros((M - S, S), dtype=torch.long, device=dev)
    swp = torch.cat([sw_sorted, pad_w])
    smp = torch.cat([sm_sorted, pad_m])
    mw, mm = swp, smp
    for _ in range(max_len - 1):
        pw = mw[0:M - 1:2] + mw[1:M:2]
        pm = mm[0:M - 1:2] + mm[1:M:2]
        pw = torch.where(pw >= _BIG, _BIG, pw)
        pm = torch.where((pw < _BIG)[:, None], pm, 0)
        allw = torch.cat([swp, pw, pad_w])
        allm = torch.cat([smp, pm, pad_m])
        o = torch.sort(allw, stable=True).indices[:M]
        mw, mm = allw[o], allm[o]

    take = torch.arange(M, device=dev) < 2 * n_active - 2
    lengths = torch.where(take[:, None], mm, 0).sum(0)
    single = torch.where(used & (n_active == 1), 1, 0)
    return torch.where(n_active == 1, single, lengths).int()


def limited_lengths_pair(ll_freq: torch.Tensor, d_freq: torch.Tensor,
                         max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Both encode-table length arrays (litlen (288,), dist (32,)); at
    least one distance code gets a length (RFC 1951 wants HDIST >= 1)."""
    ll = package_merge_device(ll_freq, max_len)
    d = package_merge_device(d_freq, max_len)
    if_none = torch.zeros_like(d)
    if_none[0] = 1
    return ll, torch.where(d.max() == 0, if_none, d)
