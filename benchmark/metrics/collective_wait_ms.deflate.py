"""Host milliseconds a MiB of input on rank 0 in the program's
``zlibes.collective`` spans, on the profiler's clock: the calls into
``torch.distributed`` and the blocking reads of what they returned.  Under
NCCL a call only queues the exchange, so the host waits in the read: for
its own work queued before it, the NCCL kernels and the slowest rank."""
from harness import spans


def read(run):
    return spans.per_mib(spans.host_s(run.trace, "zlibes.collective"),
                         run.op.work()["bytes_in"])
