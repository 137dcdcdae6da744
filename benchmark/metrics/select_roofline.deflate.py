"""``select_tokens``' share of its memory roofline over the window: the
contract bytes of every call's dispatches (``roofline/select_tokens.py``)
at 3.35 TB/s over the profiler's device time of ``select_tokens_kernel``."""
from roofline import peaks, select_tokens


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    t = run.trace.time_s(r"\bselect_tokens_kernel\b")
    if t <= 0:
        return None
    enc = run.config["encoder"]
    cfg = {"block_size": 131072, "seg_size": 4096, "blocks_per_dispatch": 16}
    cfg.update({k: v for k, v in (enc.get("codec_config") or {}).items()
                if k in cfg})
    nbytes = sum(select_tokens.contract_bytes(n, **cfg)
                 for _, _, _, n in run.op.calls)
    return peaks.share_pct(nbytes, t)
