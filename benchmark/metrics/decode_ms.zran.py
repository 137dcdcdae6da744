"""Device milliseconds a read in the group decode's kernels: the
profiler's device time of ``decode_tokens`` (its flatten launch included)
and ``resolve_global`` (its expand and every round launch), matched as
``generic_roofline.inflate`` matches them, over the reads of the window."""
KERNELS = (r"\bdecode_tokens_(flatten_)?kernel\b",
           r"\bresolve_global_(expand|round)_kernel\b")


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    t = sum(run.trace.time_s(k) for k in KERNELS)
    n = run.op.work()["reads"]
    if t <= 0 or not n:
        return None
    return t * 1e3 / n
