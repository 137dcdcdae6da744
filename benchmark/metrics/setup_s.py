"""Seconds from the process's start to the window's start: loading and
building the kernels, making the data, the set-up the traffic needs and
the warm-up (host clock)."""


def read(run):
    return run.setup_s
