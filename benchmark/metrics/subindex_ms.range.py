"""Host milliseconds a read in the program's ``zlibes.subindex`` spans:
``inflate_range``'s blocks kept, ``np.isin`` over every anchor and the
sub-index, on the profiler's clock."""
from harness import spans


def read(run):
    return spans.per_read(spans.host_s(run.trace, "zlibes.subindex"),
                          run.op.work()["reads"])
