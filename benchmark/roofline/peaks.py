"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; at the
full 700 W power limit)."""
HBM_BYTES_PER_S = 3.35e12       # HBM3
INT32_OPS_PER_S = 67e12         # float32 / int32 outside the tensor cores


def share_pct(nbytes: float, seconds: float) -> float | None:
    """The memory roofline's share of the time: the least time ``nbytes``
    could take over the time the kernel took, in percent; None where the
    trace holds no time of it."""
    if seconds <= 0:
        return None
    return nbytes / HBM_BYTES_PER_S / seconds * 100.0
