"""``decode_tokens`` (``zlibes_tpu_torch/ops/inflate_kernel.py``, CUDA
``decode_tokens_flatten_kernel`` and ``decode_tokens_kernel``), one launch
a group of the group decode.

Contract: it reads the stream's words once (``4 * ceil(len / 4)`` B), each
lane's start and end bit (int64) and output base (int32), and one table
row a coded block (the two-level litlen and distance tables, ``LL_W`` +
``D_W`` int32), and writes each token and its output offset (two int32).
Lanes are the index's anchors, coded blocks those the anchors lie in, and
tokens the literals and matches of the lanes, counted by the plain reader
(``reference/inflater.py``) under each block's own tables: all from the
stream and its index, never from the program's token slots or lanes a
group."""
from __future__ import annotations

import numpy as np

LL_W = 1024     # int32 of a litlen table row: 512 roots of 9 bits, 512 subs
D_W = 768       # int32 of a distance table row
LANE = 8 + 8 + 4
TOKEN = 4 + 4


def contract_bytes(comp_len: int, lanes: int, coded_blocks: int,
                   tokens: int) -> int:
    words = 4 * -(-comp_len // 4)
    return (words + LANE * lanes + 4 * (LL_W + D_W) * coded_blocks
            + TOKEN * tokens)


def lane_ends(ix: dict) -> np.ndarray:
    """Each lane's end bit: the next anchor of its block, or the block's
    end bit for the last."""
    bit0, blk = ix["bit"], ix["block"]
    end = np.empty_like(bit0)
    end[:-1] = bit0[1:]
    last = np.ones(bit0.size, bool)
    last[:-1] = blk[1:] != blk[:-1]
    end[last] = ix["blocks"][blk[last], 4]
    return end


def lanes_blocks_tokens(comp: bytes, ix: dict) -> tuple[int, int, int]:
    """(lanes, coded blocks, tokens) of a stream under its index's plain
    arrays: every lane walked in lock step, each under the tables of its
    block's header, end-of-block codes not counted.  A lane that does not
    end exactly at its end bit raises ``inflater.Corrupt``."""
    from reference import inflater as inf

    bit0 = np.asarray(ix["bit"], np.int64)
    if bit0.size == 0:
        return 0, 0, 0
    end = lane_ends(ix)
    blocks, rows = np.unique(ix["block"], return_inverse=True)
    bits = inf.Bits(comp)
    # every block's tables, one after another in flat arrays: a lane looks
    # up offset + (the next 15 bits masked to its table's width)
    parts = {"ls": [], "ll": [], "ds": [], "dl": []}
    offs = np.zeros((blocks.size, 2), np.int64)
    masks = np.zeros((blocks.size, 2), np.int64)
    have = [0, 0]
    for r, b in enumerate(blocks.tolist()):
        _, btype, ll, dl, _ = inf.read_header(bits, int(ix["blocks"][b, 2]))
        if btype == 0:
            raise inf.Corrupt(f"an anchor in stored block {b}")
        for k, (lens, s_key, l_key) in enumerate(((ll, "ls", "ll"),
                                                 (dl, "ds", "dl"))):
            sym, ln, maxbits = inf.table(lens)
            offs[r, k] = have[k]
            masks[r, k] = (1 << maxbits) - 1
            parts[s_key].append(sym.astype(np.int16))
            parts[l_key].append(ln.astype(np.int8))
            have[k] += sym.size
    lsym, lln, dsym, dln = (np.concatenate(parts[k])
                            for k in ("ls", "ll", "ds", "dl"))
    lext = np.array(inf.LEN_EXTRA + [0, 0], np.int64)
    dext = np.array(inf.DIST_EXTRA + [0, 0], np.int64)
    buf = np.frombuffer(bytes(comp) + bytes(8), np.uint8)
    pos = bit0.copy()
    live = np.flatnonzero(pos < end)
    total = 0
    while live.size:
        r = rows[live]
        p = pos[live]
        v = inf._peek_many(buf, p, 15) & masks[r, 0]
        s = lsym[offs[r, 0] + v].astype(np.int64)
        n = lln[offs[r, 0] + v].astype(np.int64)
        if (n == 0).any():
            raise inf.Corrupt("no litlen code in a lane")
        p = p + n
        total += int((s != inf.EOB).sum())
        m = s > inf.EOB
        if m.any():
            k = s[m] - 257
            if (k >= 29).any():
                raise inf.Corrupt("bad length symbol in a lane")
            q = p[m] + lext[k]
            rm = r[m]
            dv = inf._peek_many(buf, q, 15) & masks[rm, 1]
            d = dsym[offs[rm, 1] + dv].astype(np.int64)
            dn = dln[offs[rm, 1] + dv].astype(np.int64)
            if (dn == 0).any() or (d >= 30).any():
                raise inf.Corrupt("bad distance in a lane")
            p[m] = q + dn + dext[d]
        pos[live] = p
        done = (p >= end[live]) | (s == inf.EOB)
        live = live[~done]
    if (pos != np.maximum(end, bit0)).any():
        raise inf.Corrupt("a lane did not end at its end bit")
    return bit0.size, blocks.size, total
