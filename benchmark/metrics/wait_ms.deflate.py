"""Host milliseconds a MiB of input in the program's ``zlibes.readback``
spans, the blocking copies from the card to the host: the host waiting on
the card (on a four-card cell, rank 0's, on the slowest rank too), on the
profiler's clock."""
from harness import spans


def read(run):
    return spans.per_mib(spans.host_s(run.trace, "zlibes.readback"),
                         run.op.work()["bytes_in"])
