"""Compressed over input bytes, summed over every file of the run, each
counted at the first stream the port returned for it (a file the window did
not reach is compressed once after it, untimed)."""


def read(run):
    return run.op.stored_ratio()
