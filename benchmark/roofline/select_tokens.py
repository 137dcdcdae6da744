"""``select_tokens`` (``zlibes_tpu_torch/ops/lz77.py``, CUDA
``select_tokens_kernel``), one launch a dispatch of the general encoder.

Contract: per dispatch of ``B`` block rows of ``N`` positions and
``N / seg`` lanes a row, it reads each valid position's byte (1 B) and
match (int32, 4 B) and each row's valid count (4 B), and writes the token
values and distances of every lane slot ((B * N) int32 each) and each
lane's token count (4 B).  Sizes: the input's length ``n`` and the
configuration's block size, segment size and blocks a dispatch (the last
dispatch is padded to ``B`` rows, whose slots the contract fills too)."""


def contract_bytes(n: int, block_size: int = 131072, seg_size: int = 4096,
                   blocks_per_dispatch: int = 16) -> int:
    blocks = -(-n // block_size)
    dispatches = -(-blocks // blocks_per_dispatch)
    rows = dispatches * blocks_per_dispatch
    lanes = rows * (block_size // seg_size)
    read = 5 * n + 4 * rows
    written = 8 * rows * block_size + 4 * lanes
    return read + written
