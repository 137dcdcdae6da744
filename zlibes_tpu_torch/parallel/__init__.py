"""Block parallelism over a ``torch.distributed`` process group (the port of
``zlibes_tpu/parallel/``): ``make_mesh``, ``parallel_deflate``,
``parallel_inflate``, the dictionary batch and multi-host set-up."""
from .block_parallel import (  # noqa: F401
    LAST_TIMINGS,
    Mesh,
    make_mesh,
    parallel_deflate,
    parallel_inflate,
    parallel_inflate_turbo,
    parallel_inflate_wide,
    sharded_deflate_step,
    sharded_inflate_step,
    sharded_turbo_inflate_step,
)
from . import multihost  # noqa: F401
from .batch import compress_batch, decompress_batch  # noqa: F401
