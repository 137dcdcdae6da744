"""Host milliseconds a MiB of output in the program's ``zlibes.upload``
spans: the stream's words, the lane arrays and the tables going to the
card, on the profiler's clock."""
from harness import spans


def read(run):
    return spans.per_mib(spans.host_s(run.trace, "zlibes.upload"),
                         run.op.work()["bytes_out"])
