"""Device milliseconds a MiB of input of the work launched inside the
program's ``zlibes.match`` spans (the matcher, ``find_matches``)."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    s = run.trace.span_device_s("zlibes.match")
    b = run.op.work()["bytes_in"]
    return None if s is None or not b else s * 1e3 / (b / 2**20)
