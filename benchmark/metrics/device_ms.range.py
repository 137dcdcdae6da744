"""Device busy milliseconds a range read: the union of the device's busy
intervals over the traced window, over the reads it made (the wide decode,
its glue and the uploads)."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    n = run.op.work()["reads"]
    return run.trace.busy_s * 1e3 / n if n else None
