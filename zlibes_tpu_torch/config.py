"""Codec configuration, per-call statistics and named stage spans.

The port's own copy of ``zlibes_tpu/config.py``: the same knobs, as a
frozen dataclass, with a level→preset mapping so ``level=`` behaves like
users expect from zlib.  ``config_from_reference`` rebuilds a
``CodecConfig`` from any object that carries the same fields.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from dataclasses import dataclass, field

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from .spec import constants as C


@dataclass(frozen=True)
class CodecConfig:
    """Tuning knobs for the deflate pipeline."""

    block_size: int = C.BLOCK_MAX_BUFFER_LEN  # bytes per DEFLATE block
    seg_size: int = 4096       # greedy-selection segment / decode anchor span
    probe_words: int = 16      # match-length probe u32s (cap = 4*S+3 bytes;
    # S=16/J=24 is +0.054% size vs S=32/J=24 on raw.bin for half the
    # matcher's probe words)
    candidates: int = 24       # sorted-order match candidates per position
    lazy: bool = True          # one-step lazy matching
    blocks_per_dispatch: int = 16
    force_stored: bool = False  # level 0: raw stored blocks, no coding
    chunk_reset: int = 0  # >0 (power of two, multiple of seg_size): LZ
    # window resets every chunk_reset output bytes, making every chunk
    # independently resolvable — what the turbo inflate kernels need; 0
    # keeps the full 32 KiB window
    shared_tables: bool = False  # one stream-wide Huffman table pair
    # (identical header in every block): lets the decode kernel hold ONE
    # table in shared memory for all lanes, and the encoder skip per-block
    # host table builds.  Small ratio cost vs per-block tables.
    max_code_bits: int = 15  # length-limit for litlen/dist codes; the
    # turbo profile caps at 9 so the decode kernel's primary lookup is a
    # single 512-entry table (no secondary resolution step)
    phase1_cache_blocks: int = 256  # shared-table encode: keep phase-1
    # token arrays for up to this many blocks; beyond it (inputs > 32 MiB
    # at 128 KiB blocks) phase 2 RE-RUNS match+select per span instead —
    # bit-exact (the device pipeline is deterministic; tested), costing
    # one extra match+select pass over the input

    def __post_init__(self):
        if self.chunk_reset:
            if self.chunk_reset & (self.chunk_reset - 1):
                raise ValueError("chunk_reset must be a power of two")
            if self.seg_size > self.chunk_reset:
                object.__setattr__(self, "seg_size", self.chunk_reset)
            if self.chunk_reset % self.seg_size:
                raise ValueError("chunk_reset must be a multiple of seg_size")
        if not 7 <= self.max_code_bits <= 15:
            raise ValueError("max_code_bits must be in 7..15")

    def pack_row_width(self, seg_size: int | None = None) -> int:
        """Word-slot row width R of the dense pack: enough u32 slots for
        a worst-case segment (every coded bit) plus 2 carry slots, rounded
        up to a multiple of 8.  Single source of truth — the pipeline and
        every measurement must use the same row width."""
        s = self.seg_size if seg_size is None else seg_size
        return -(-((s * self.max_code_bits + 31) // 32 + 2) // 8) * 8

    @staticmethod
    def turbo(candidates: int = 12, probe_words: int = 4,
              lazy: bool = True) -> "CodecConfig":
        """The fast profile: streams remain 100% zlib-conformant (any
        inflate decodes them) but carry the structure the lane-parallel
        inflate kernels need — window reset every 4 KiB, decode anchors
        every 512 B (paired with a mid-segment split anchor for 256 B-grain
        decode lanes), one shared stream-wide table pair with code lengths
        capped at 9 bits, and no token wider than 32 bits (far long
        matches are capped at 130 bytes).  (probe_words, candidates)
        default to the reference's speed/ratio knee: S=4/J=12 is +0.1%
        compressed size vs S=6/J=12 (0.4208 vs 0.4204 on the bench
        corpus); the 19-byte probe cap is backstopped by the dist-1 run
        detector for long RLE matches."""
        return CodecConfig(
            seg_size=512, chunk_reset=4096, shared_tables=True,
            max_code_bits=9, candidates=candidates,
            probe_words=probe_words, lazy=lazy)

    @staticmethod
    def from_level(level: int) -> "CodecConfig":
        """zlib-style levels 1 (fast) .. 9 (best).  Level 0 = stored only."""
        if not 0 <= level <= 9:
            raise ValueError("level must be 0..9")
        if level == 0:
            return CodecConfig(probe_words=1, candidates=0, lazy=False,
                               force_stored=True)
        # the reference's presets: candidates J buy ratio, probe depth S
        # barely does, so every level caps S at 16 and the top levels buy
        # their ratio with deeper candidate scans (S=16/J=64 gives
        # 188,380 B on raw.bin).  Sizes do not depend on the hardware.
        table = {
            1: dict(probe_words=4, candidates=2, lazy=False),
            2: dict(probe_words=4, candidates=4, lazy=False),
            3: dict(probe_words=8, candidates=4, lazy=False),
            4: dict(probe_words=8, candidates=8, lazy=False),
            5: dict(probe_words=8, candidates=8, lazy=True),
            6: dict(probe_words=16, candidates=24, lazy=True),
            7: dict(probe_words=16, candidates=32, lazy=True),
            8: dict(probe_words=16, candidates=48, lazy=True),
            9: dict(probe_words=16, candidates=64, lazy=True),
        }
        return CodecConfig(**table[level])


DEFAULT_CONFIG = CodecConfig()


@dataclass
class CodecStats:
    """Per-call observability: byte and block counts, and in ``stage_s``
    the host seconds of each stage the call passed this dict to
    (``trace(name, stats.stage_s)``), keyed by the span's name without its
    ``zlibes.`` prefix."""

    bytes_in: int = 0
    bytes_out: int = 0
    blocks: int = 0
    dispatches: int = 0
    device_tables: int = 0  # blocks whose coding choice and tables the
    # card built (the general encoder's block_tables kernel)
    chained_groups: int = 0  # decode groups resolved behind the previous
    # group's output on the device (a chained index's group decode)
    device_headers: int = 0  # coded blocks whose header and decode-table
    # row the card built (the decoders' decode_tables kernel)
    device_lanes: int = 0  # wide decode lanes whose spans the card built
    # from the index's anchors (the wide plan's wide_lanes kernel)
    point_reads: int = 0  # inflate_range reads decoded from an access point
    # of a chained index, behind its window (as zlib's examples/zran.c)
    lead_bytes: int = 0  # output those reads decoded before their start
    stage_s: dict = field(default_factory=dict)
    adler: int | None = None  # trailer checksum, when the encode pipeline
    # folded its device Adler terms into the phase-1 dispatches

    @property
    def ratio(self) -> float:
        return self.bytes_out / self.bytes_in if self.bytes_in else 0.0


_SPAN_PREFIX = "zlibes."


class _Stage:
    """A stage's span: a ``record_function`` of its name, made and entered
    only when a profiler ran as the span was made (its set-up costs more
    than the rest of the span), and the stage's host seconds added to
    ``into`` under the name without its prefix when given a dict."""

    __slots__ = ("name", "into", "rf", "t0")

    def __init__(self, name: str, into: dict | None, on: bool):
        self.name, self.into = name, into
        self.rf = record_function(name) if on else None
        self.t0 = 0.0

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        if self.into is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            key = self.name[len(_SPAN_PREFIX):]
            self.into[key] = (self.into.get(key, 0.0)
                              + time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


# the span of every stage that neither a profiler nor a clock looks at
_IDLE = contextlib.nullcontext()


def trace(name: str, into: dict | None = None):
    """The one stage helper: a named span around a stage (``zlibes.match``,
    ``zlibes.plan``, ...), used as ``with trace(name, stats.stage_s):``.

    The span is a ``torch.profiler.record_function``: a user annotation on
    the profiler's clock, holding the device work launched inside it, in a
    ``torch.profiler`` trace, and an NVTX range under
    ``torch.autograd.profiler.emit_nvtx``, when a profiler runs on the
    calling thread as the span is made; with none it is not entered and
    costs the host under a microsecond.  ``into`` (a ``CodecStats.stage_s``
    or ``parallel.LAST_TIMINGS``) gets the stage's host seconds added under
    the name without its ``zlibes.`` prefix, whether a profiler runs or
    not."""
    on = _profiler_enabled()
    if not on and into is None:
        return _IDLE
    return _Stage(name, into, on)


def span(name: str):
    """Decorator: every call of the function is one span ``name``
    (``trace(name)``), such as a public call's root ``zlibes.deflate``.
    ``fn.__wrapped__`` is the function without it, for a caller already
    inside such a span."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with trace(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def config_from_reference(obj) -> CodecConfig:
    """Rebuild the port's ``CodecConfig`` from any object that carries the
    same fields (for example the JAX package's), by reading attributes
    only.  A missing field raises AttributeError."""
    if isinstance(obj, CodecConfig):
        return obj
    return CodecConfig(**{f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(CodecConfig)})
