"""Input bytes of every compress call of the window over the window's time,
the calls back to back, each ending with its stream's bytes on the host
(host clock; GB = 1e9 B)."""


def read(run):
    return run.op.work()["bytes_in"] / run.window_s / 1e9
