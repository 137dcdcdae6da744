"""The median of the same reads as ``range_p95_ms``, in the traced run."""


def read(run):
    return run.op.work()["p50_ms"]
