"""Host milliseconds a MiB of input in the encoder's host stages: the
``CodecStats.stage_s`` entries ``tables``, ``splice`` and ``entropy`` (the
program's own host-clock timers around host-only work)."""

STAGES = ("tables", "splice", "entropy")


def read(run):
    w = run.op.work()
    if not w["bytes_in"]:
        return None
    s = sum(w["stage_s"].get(k, 0.0) for k in STAGES)
    return s * 1e3 / (w["bytes_in"] / 2**20)
