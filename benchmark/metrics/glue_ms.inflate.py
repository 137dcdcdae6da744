"""Device milliseconds a MiB of output of every kernel of the window other
than ``decode_turbo`` and ``resolve_turbo``: the eager glue between them
and whatever else the decode launches (profiler; copies not counted)."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    b = run.op.work()["bytes_out"]
    if not b:
        return None
    named = (run.trace.time_s(r"\bdecode_turbo_kernel\b")
             + run.trace.time_s(r"\bresolve_turbo_kernel\b"))
    return (run.trace.kernel_s() - named) * 1e3 / (b / 2**20)
