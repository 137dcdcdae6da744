"""Host milliseconds a read in the program's ``zlibes.upload`` spans: the
whole stream's words, the lane arrays and the tables going to the card, on
the profiler's clock."""
from harness import spans


def read(run):
    return spans.per_read(spans.host_s(run.trace, "zlibes.upload"),
                          run.op.work()["reads"])
