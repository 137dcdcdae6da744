"""Host milliseconds a read in the plan builds of the range reads: the self
time of the program's ``zlibes.plan`` spans (``WidePlan.build``), their
``zlibes.upload`` and ``zlibes.readback`` children left out, on the
profiler's clock."""
from harness import spans


def read(run):
    s = spans.self_s(run.trace, "zlibes.plan",
                     ("zlibes.upload", "zlibes.readback"))
    return spans.per_read(s, run.op.work()["reads"])
