"""Host milliseconds a MiB of output in the decode's plan builds: the self
time of the program's ``zlibes.plan`` spans (``TurboPlan.build``), their
``zlibes.upload`` and ``zlibes.readback`` children left out, on the
profiler's clock."""
from harness import spans


def read(run):
    s = spans.self_s(run.trace, "zlibes.plan",
                     ("zlibes.upload", "zlibes.readback"))
    return spans.per_mib(s, run.op.work()["bytes_out"])
