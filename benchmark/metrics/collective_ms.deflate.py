"""Device milliseconds a MiB of input of the NCCL kernels on rank 0 (the
histogram ``all_reduce`` and the two ``all_gather``s of every call), from
the profiler's trace."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    n = run.trace.count(r"(?i)nccl")
    b = run.op.work()["bytes_in"]
    if not n or not b:
        return None
    return run.trace.time_s(r"(?i)nccl", kernels_only=True) * 1e3 / (
        b / 2**20)
