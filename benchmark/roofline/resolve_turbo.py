"""``resolve_turbo`` (``zlibes_tpu_torch/ops/turbo_kernel.py``, CUDA
``resolve_turbo_kernel``), one launch a turbo decode.

Contract: ``toks, starts (16, C, 384) int32 -> (C, 4096) uint8``: one
4 KiB chunk row for each 4,096 bytes of output (the turbo profile's window
reset), 16 sub-spans of 256 B a row, 384 token slots a sub-span.  Reads
both token arrays once and writes the rows once; ``C`` comes from the
output's length."""

SUBS = 16
SLOTS = 384
CHUNK = 4096


def contract_bytes(total_out: int) -> int:
    rows = max(1, -(-total_out // CHUNK))
    return rows * (2 * SUBS * SLOTS * 4 + CHUNK)
