"""``decode_tokens`` and ``resolve_global`` together against their memory
roofline: the contract bytes of both for every decode of the window
(``roofline/decode_tokens.py``, ``roofline/resolve_global.py``) at 3.35
TB/s over the sum of both kernels' profiler device time, the decode's
flatten launch and every round launch of the resolve included."""
from roofline import decode_tokens, peaks, resolve_global

KERNELS = (r"\bdecode_tokens_(flatten_)?kernel\b",
           r"\bresolve_global_(expand|round)_kernel\b")


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    t = sum(run.trace.time_s(k) for k in KERNELS)
    if t <= 0:
        return None
    per_file = {}
    for item, _, _, n in run.op.calls:
        if item not in per_file:
            comp, ix = run.stream_arrays(item)
            lanes, blocks, tokens = decode_tokens.lanes_blocks_tokens(comp,
                                                                      ix)
            per_file[item] = (
                decode_tokens.contract_bytes(len(comp), lanes, blocks, tokens)
                + resolve_global.contract_bytes(tokens, n))
    return peaks.share_pct(sum(per_file[c[0]] for c in run.op.calls), t)
