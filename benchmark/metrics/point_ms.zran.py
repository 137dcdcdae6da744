"""Host milliseconds a read in the program's ``zlibes.point`` spans: the
access point's lookup, the cut of the stream to the read's blocks and its
upload with the point's 32 KiB window (a ``zlibes.upload`` child, counted
here), on the profiler's clock."""
from harness import spans


def read(run):
    return spans.per_read(spans.host_s(run.trace, "zlibes.point"),
                          run.op.work()["reads"])
