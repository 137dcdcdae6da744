"""``decode_turbo`` (``zlibes_tpu_torch/ops/turbo_kernel.py``, CUDA
``decode_turbo_kernel``), one launch a turbo decode.

Contract: it reads the stream's words once (``4 * ceil(len / 4)`` B), three
int32 a lane (first window word, start and end bit) and the two 512-entry
int32 decode tables, and writes one int32 a token and four int32 of meta a
lane.  Lanes are the index's anchors, tokens the literals and matches the
stream holds: both come from the input, the tokens counted by the plain
reader (``reference/inflater.py``), never from the program's tensors."""
from __future__ import annotations

import numpy as np

TABLE = 512


def contract_bytes(comp_len: int, lanes: int, tokens: int) -> int:
    words = 4 * -(-comp_len // 4)
    return words + 12 * lanes + 2 * 4 * TABLE + 4 * tokens + 16 * lanes


def lanes_and_tokens(comp: bytes, ix: dict) -> tuple[int, int]:
    """(lanes, tokens) of a turbo stream under its index's plain arrays:
    a lane runs from its anchor to the next anchor of its block, the last
    of a block to the block's end; every coded block shares the first
    one's tables."""
    from reference import inflater as inf

    blocks = ix["blocks"]
    bit0, blk = ix["bit"], ix["block"]
    end = np.empty_like(bit0)
    end[:-1] = bit0[1:]
    last = np.ones(bit0.size, bool)
    last[:-1] = blk[1:] != blk[:-1]
    end[last] = blocks[blk[last], 4]
    coded = blocks[blocks[:, 0] == 2]
    _, _, ll, dl, _ = inf.read_header(inf.Bits(comp), int(coded[0, 2]))
    return bit0.size, inf.count_tokens(comp, bit0, end, ll, dl)
