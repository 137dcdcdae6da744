"""``resolve_global`` (``zlibes_tpu_torch/ops/inflate_kernel.py``, CUDA
``resolve_global_expand_kernel`` and one ``resolve_global_round_kernel`` a
round), one call a group of the group decode.

Contract: it reads each token and its output offset once (two int32) and
writes each output byte once.  Tokens come from the stream and its index
(``roofline/decode_tokens.py``), output bytes from the stream's length;
the up to 32 KiB prefix a chained group reads, and the rounds' reads of
the bytes' sources, are left out."""

TOKEN = 4 + 4


def contract_bytes(tokens: int, total_out: int) -> int:
    return TOKEN * tokens + total_out
