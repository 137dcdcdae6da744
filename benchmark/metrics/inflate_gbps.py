"""Output bytes of every whole-stream decode of the window over the
window's time, each decode ending with its bytes ready on the card (host
clock; GB = 1e9 B)."""


def read(run):
    return run.op.work()["bytes_out"] / run.window_s / 1e9
