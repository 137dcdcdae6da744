"""``decode_turbo`` and ``resolve_turbo`` together against their memory
roofline: the contract bytes of both for every decode of the window
(``roofline/decode_turbo.py``, ``roofline/resolve_turbo.py``) at 3.35 TB/s
over the sum of both kernels' profiler device time."""
from roofline import decode_turbo, peaks, resolve_turbo


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    t = (run.trace.time_s(r"\bdecode_turbo_kernel\b")
         + run.trace.time_s(r"\bresolve_turbo_kernel\b"))
    if t <= 0:
        return None
    per_file = {}
    for item, _, _, n in run.op.calls:
        if item not in per_file:
            comp, ix = run.stream_arrays(item)
            lanes, tokens = decode_turbo.lanes_and_tokens(comp, ix)
            per_file[item] = (decode_turbo.contract_bytes(len(comp), lanes,
                                                          tokens)
                              + resolve_turbo.contract_bytes(n))
    return peaks.share_pct(sum(per_file[c[0]] for c in run.op.calls), t)
