"""The device's idle share of the traced window: 1 - (the union of the
device's busy intervals, kernels and copies) / (the window's length), in
percent."""


def read(run):
    if run.trace is None or not run.trace.ops or run.window_s <= 0:
        return None
    return (1.0 - run.trace.busy_s / run.window_s) * 100.0
