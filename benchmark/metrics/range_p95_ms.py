"""The 95th percentile of every range read of the window, each timed on the
host clock from its call to its returned bytes."""


def read(run):
    return run.op.work()["p95_ms"]
