"""Drive the PyTorch port's inflate, encode and block-parallel paths once on
one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``zlibes_tpu_torch/csrc/`` and drives
these paths on the 3.84 MB bench corpus and its committed fixtures
(the tables of the decoders on an nci-sized file):

  * turbo inflate: ``tests/golden/turbo_bench.*`` (``CodecConfig.turbo()``),
    kernels ``decode_turbo`` (which stages its lane windows itself) and
    ``resolve_turbo``;
  * wide inflate: ``tests/golden/wide_bench.*`` (level 6, zlib's default),
    kernels ``decode_wide`` (likewise) and ``resolve_wide``, plus the seek
    (``inflate_range``) and the device-resident output
    (``inflate_to_device``);
  * turbo encode: ``zlibes_tpu_torch.deflate(corpus,
    config=CodecConfig.turbo())``, kernels ``select_turbo`` and
    ``encode_fields``; its output must equal ``turbo_bench.zz`` byte for
    byte, its index ``turbo_bench.idx.npz``, and decode back to the corpus;
  * general encode: ``zlibes_tpu_torch.deflate(corpus, level=6)``, kernel
    ``select_tokens``; its output must equal ``wide_bench.zz`` byte for
    byte, its index ``wide_bench.idx.npz``, and come back through CPython
    and through the port's wide inflate; levels 0, 1 and 9 and a preset
    dictionary on ``tests/golden/raw.bin``, ``deflate_indexed`` and
    ``backend="refmodel"`` once each;
  * generic inflate: the corpus through CPython zlib at level 6 with a full
    flush every 32 KiB (self-contained) and without (chained), indexed by
    ``build_index``, kernels ``decode_tokens`` and ``resolve_global``:
    ``inflate_to_device`` (the main path: one group, one launch of each;
    the chained index too, its groups in order, each behind the one
    before), a seek across a block boundary, a stored block between
    dynamic ones,
    ``inflate_raw_indexed`` on both indexes, the scan without an index
    (``inflate_raw_scan(device="cuda")``, one lane a block) and
    ``inflate()`` with and without the native runtime;
  * the decoders' per-block tables: ``decode_tables`` on the stock-zlib
    and the wide plan of an nci-sized file (the bench's largest read
    file), exact against its plain version (the host parse), timed, and
    once a call through ``inflate_to_device``;
  * shared-table encode outside the turbo profile: ``deflate(corpus,
    config=...)`` for ``shared_full``, ``shared_turbo15`` and
    ``shared_seg1024`` (``tests/shared_tables_cases.py``), kernels
    ``select_tokens`` (``split_far`` off on 512-byte lanes, on on
    1,024-byte lanes) or ``select_turbo`` (``split_far`` off), and
    ``encode_fields`` (fields of up to 48 bits); each stream and index
    must equal ``tests/golden/shared_bench.json``'s digests, and come back
    through CPython, ``inflate(index=)``, ``inflate()``, ``inflate_range``
    and ``inflate_to_device`` (kernels ``decode_tokens`` and
    ``resolve_global``); the same on the two 64 KiB buffers whose coded
    tokens pass 32 bits; each kernel variant against its plain version;
  * block parallelism (``zlibes_tpu_torch.parallel``), in a NCCL world of
    one rank on the card: ``parallel_deflate`` of the corpus dynamic,
    fixed and turbo (with its index), each held against the reference's
    length and SHA-256 in ``tests/golden/parallel_bench.json`` and CPython;
    ``parallel_inflate`` of ``turbo_bench.*``, ``wide_bench.*``, the
    generic phase's 32 KiB-flush stream and the turbo stream just written;
    ``compress_batch`` of 256 payloads of 1-4 KiB against a 32 KiB
    dictionary, back through CPython and ``decompress_batch``; each with
    its launches, phases (``LAST_TIMINGS``), peak device memory and whole
    call beside the single-device call; then a gloo world of two ranks on
    the one card (``chip_smoke.py --parallel-rank``, two processes), whose
    bytes must be the world of one's and where a corrupted turbo stream
    must raise CorruptError on both ranks.

For each path it holds every kernel against its plain PyTorch version at
the path's shapes, runs the path through its public entry point on the
card with the launch counts set to 0 just before and read just after,
times the kernels and the pipeline with CUDA events and torch.profiler,
and (inflate) probes corrupted streams.  From the profiler trace of the
turbo and the level-6 ``deflate()`` calls it reads the encoder's named
stage spans (``zlibes_tpu_torch.config.trace``: ``zlibes.match``,
``zlibes.select``, ``zlibes.symbols``, ``zlibes.pack`` and ``zlibes.upload``
a dispatch, the general encoder's ``zlibes.tables``, ``zlibes.splice`` and
readbacks a dispatch too, and the call's root ``zlibes.deflate`` with its
other stages) and prints for each its count a call, the device ms a call
of the work launched inside it and the device range the profiler
annotates with its name; a call that enters another span, or an expected
one other than as often as its dispatches say, fails the run.  ``resolve_wide`` is also held
against its plain version on rows of 32 KiB and of 256 KiB (the kernel's
path for rows too long for shared memory), ``select_turbo`` on the
corpus' second dispatch (padded lanes) with ``lazy`` on and off,
``decode_turbo`` on 4,096 lanes of random bits and on the fixture with ``T``
cut to 64 (and the encode kernels at the parallel path's shapes:
``select_tokens`` in segments of 1,024 on 16 blocks of 32 KiB and behind
the batch's 32 KiB dictionary, ``select_turbo`` and ``encode_fields`` on a
parallel turbo dispatch), ``resolve_turbo`` on random tokens under unsorted starts with
self-copies among them and on one chunk row alone, ``decode_wide`` on
random bits under the fixture's tables and on the fixture with ``T`` cut to
16, ``select_tokens`` on the corpus' second dispatch (padded blocks, a
ragged last block), on random matches with ``lazy`` on and off, segments
of 4,096 and 1,024 and a context prefix of 0 and 32,768, on the chain cases
of its design (``SELECT_CHAIN_CASES`` of ``tests/test_torch_contract_cases.py``:
a lane of 16,384 literals, lanes of 1,024 and 1,025 tokens, 258-byte
matches, lanes of 0-3 positions, a match to the lane's end, growing
lengths, parses that never meet, a match over eight pieces; with and
without a 32 KiB prefix) and on the dispatch of 1 MiB of seeded random
bytes, whose level-6 encode must come back through CPython, ``decode_tokens``
with ``T`` cut to 512 (lanes resumed call after call), on 4,096 lanes of
random bits, on the scan's single lane of a 50 KB stream, on one warp of 32
distinct table rows, on codes of 12-15 bits with 13-bit distance extras, on
tokens ending on and one bit past a lane's end and on one lane of 65,800
tokens resumed, ``resolve_global`` with the unwritten slots random, behind
a 32 KiB prefix, on random lanes reaching below byte 0, on a distance-1 run
of 1 MiB, on copies across tile and lane boundaries, on overlapping copies
and on an (n, 1) lane of 1,050,000 tokens behind a 32 KiB prefix.  Both
wide and turbo decoders are
held in the form the pipelines call,
``decode_*((words, start_w), ...)``, against the plain decode of the plain
windows; the stand-alone ``lane_windows`` kernel, which no path launches any
more, is still held against its plain version at both widths.  For
``decode_turbo`` and ``decode_wide``, which their longest lane bounds, it
prints that lane's and the mean lane's token count, the steps and the
device cycles a step, for ``decode_tokens`` too; for ``select_tokens`` on
the bench and the incompressible dispatch its device time and cycles, the
lanes' tokens, and the fix-up rounds, walks and longest speculative walk of
the kernel's procedure in numpy (``select_tokens_model``, held exactly
against the kernel there), with ``select_turbo``'s device time beside it;
for ``resolve_global``
its expand and rounds and how many rounds found a byte open, and for the
scan its busy time and ``decode_tokens``' share of it.  The native phase
also inflates a CPython stream
with the index ``build_index`` makes for it.  Any failure raises.  The last
line of standard output is one JSON object naming the device; the line
before it is the card's name and power limit from nvidia-smi, and the line
before that the per-kernel JSON record (``launches`` is the count of the
path's run through the public entry point, ``parallel_launches`` those of
each call of the parallel phase, ``shared_launches`` those of each
shared-tables config's ``deflate``: 0 for ``lane_windows``, whose
``note`` says where its work went; ``bound_ms`` is the larger of the bytes
each kernel's contract moves over the card's memory rate and its
operations over the card's peak rate; ``library_ms`` is null: no single
PyTorch call computes any of these functions).  Imports no JAX and nothing
of ``zlibes_tpu``.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
TURBO_SRC = "zlibes_tpu/ops/turbo_kernel.py"
WIDE_SRC = "zlibes_tpu/ops/wide_kernel.py"
ENCODE_SRC = "zlibes_tpu/ops/encode_kernel.py"

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; 67 TFLOP/s float32 outside
# the tensor cores, the rate the kernels' integer operations are held to
HBM_BYTES_PER_S = 3.35e12
# numpy.random.default_rng seed of the incompressible encode (1 MiB)
INCOMPRESSIBLE_SEED = 0
OPS_PER_S = 67e12
# the spans each encoder enters a dispatch, and once a call besides
# (tests/test_torch_trace.py; the general encoder's third readback is that
# of a dispatch with a coded block, every dispatch of the corpus)
TURBO_SPANS = {"zlibes.match": 1, "zlibes.select": 1, "zlibes.symbols": 1,
               "zlibes.pack": 1, "zlibes.upload": 1}
TURBO_CALL_SPANS = {"zlibes.deflate": 1, "zlibes.entropy": 2,
                    "zlibes.readback": 2, "zlibes.upload": 1,
                    "zlibes.splice": 1}
GENERAL_SPANS = {"zlibes.match": 1, "zlibes.select": 1, "zlibes.symbols": 1,
                 "zlibes.upload": 1, "zlibes.readback": 2, "zlibes.tables": 1,
                 "zlibes.pack": 1, "zlibes.splice": 1}
GENERAL_CALL_SPANS = {"zlibes.deflate": 1, "zlibes.adler": 1,
                      "zlibes.upload": 1, "zlibes.readback": 1}


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: ``nbytes`` (each input read once,
    each output written once, counted from this run's tensors) over the
    memory rate, or ``ops`` (an estimate per item, stated where it is
    made) over the peak rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=int(nbytes), ops=int(ops))


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, runs: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def wall_s(fn, runs: int = 5) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


class Trace(dict):
    """Kernel name -> mean device ms a launch, averaged over the records
    ``torch.profiler`` kept (it drops records late in a long run, so a sum
    divided by the calls would under-count); ``records``: name -> number of
    records; ``busy``: device-busy ms a traced call (the union of the
    kernels' spans over the calls); ``spans``: the encoder's named stage
    spans (``zlibes.*``, ``zlibes_tpu_torch.config.trace``), name ->
    ``(count, device_ms, range_ms)`` a call: how often the host entered it,
    the device time of the work launched inside it, and the device range
    the profiler annotates with its name, gaps included (None when the
    trace holds no such range)."""

    def __init__(self, means: dict, records: dict, busy: float,
                 spans: dict):
        super().__init__(means)
        self.records = records
        self.busy = busy
        self.spans = spans


def is_span(e) -> bool:
    """Whether a trace event is one of the encoder's named stage spans."""
    return e.name.startswith("zlibes.")


def stage_spans(events, runs: int) -> dict:
    """Name -> (count, device ms, annotated device range ms), each a call,
    of the ``zlibes.*`` spans among a trace's events.  A span's device ms
    is the time of the device records (kernels, copies, fills) whose
    runtime call (``cudaLaunchKernel``, ...) the host made inside it: the
    profiler links a kernel launched through ``ctypes`` to no operator."""
    from torch.autograd import DeviceType

    host = [e for e in events
            if is_span(e) and e.device_type == DeviceType.CPU]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    work = [(launched[e.id], e.time_range.end - e.time_range.start)
            for e in events if e.device_type == DeviceType.CUDA
            and not is_span(e) and e.id in launched]
    out = {}
    for name in sorted({e.name for e in host}):
        mine = [e.time_range for e in host if e.name == name]
        dev = sum(us for t, us in work
                  if any(r.start <= t <= r.end for r in mine))
        ranges = [e.time_range.end - e.time_range.start for e in events
                  if e.name == name and e.device_type == DeviceType.CUDA]
        out[name] = (len(mine) / runs, dev / runs / 1e3,
                     sum(ranges) / runs / 1e3 if ranges else None)
    return out


def profile_pipeline(fn, card: str, runs: int = 5,
                     quiet: bool = False) -> Trace:
    """Trace ``runs`` calls of ``fn`` with torch.profiler; print each
    kernel's mean device time over its records and the number of records,
    and the device's idle share of the traced window (only the record
    counts when ``quiet``).  Returns a ``Trace`` (empty when the trace holds
    no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    stages = stage_spans(events, runs)
    # the device ranges of the stage spans are annotations, not kernels
    kern = [e for e in events
            if e.device_type == DeviceType.CUDA and not is_span(e)]
    if not kern:
        print("profiler: the trace holds no device activity; "
              "device times not measured")
        return Trace({}, {}, 0.0, stages)
    per_name: dict[str, list[float]] = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    for e in kern:
        per_name.setdefault(e.name, []).append(
            e.time_range.end - e.time_range.start)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    trace = Trace({name: statistics.fmean(us) / 1e3
                   for name, us in per_name.items()},
                  {name: len(us) for name, us in per_name.items()},
                  busy / runs / 1e3, stages)
    top = sorted(per_name, key=lambda k: -sum(per_name[k]))
    if quiet:
        print("profiler records (" + f"{runs} calls): " + ", ".join(
            f"{name[:40]} {trace.records[name]}" for name in top[:6]))
        return trace
    print(f"profiler ({runs} device-pipeline calls): device busy "
          f"{trace.busy:.4f} ms per call, idle share "
          f"{1 - busy / window:.3f} of the {window / runs / 1e3:.4f} ms "
          f"per call between first and last kernel {card}")
    for name in top[:12]:
        print(f"  device {trace[name]:.4f} ms a launch, mean of "
              f"{trace.records[name]} records  {name[:100]}")
    return trace


def span_report(what: str, trace: Trace, per_dispatch: dict, per_call: dict,
                dispatches: int, card: str) -> None:
    """Print each stage span's count and device ms a ``deflate()`` call of
    a traced encode; fail unless the call entered each span of
    ``per_dispatch`` as often as it says a dispatch, those of ``per_call``
    as often a call besides, and no other ``zlibes.*`` span."""
    got = {name: count for name, (count, _, _) in trace.spans.items()}
    want = {name: k * dispatches for name, k in per_dispatch.items()}
    for name, k in per_call.items():
        want[name] = want.get(name, 0) + k
    assert got == want, f"{what}: stage spans a call {got} != {want}"
    for name in sorted(want):
        count, dev, rng = trace.spans[name]
        print(f"span {name} ({what}): {count:g} a deflate() call "
              f"({dispatches} dispatches), device {dev:.4f} ms a call (the "
              f"device work launched inside it), annotated device range "
              + (f"{rng:.4f} ms" if rng is not None else "not in the trace")
              + f" {card}")


def kernel_event_ms(fn, name: str, runs: int = 10) -> tuple[float, int]:
    """Mean device ms of the ``<name>_kernel`` launches that torch.profiler
    records over ``runs`` calls of ``fn``, and how many it recorded (a mean
    over the records, so a record the trace drops does not count as a
    launch that took no time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    pat = re.compile(rf"\b{name}_kernel\b")
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and pat.search(e.name)]
    assert us, f"the profiler's trace holds no {name}_kernel"
    return statistics.fmean(us) / 1e3, len(us)


def device_time(ms: Trace, name: str) -> float:
    """Device ms a launch of ``name``'s wrapper: over the kernels named
    ``<name>_kernel`` or ``<name>_<part>_kernel`` (resolve_wide has two a
    launch, ..._expand_kernel and ..._walk_kernel; resolve_global an expand
    and its rounds), the sum of each kernel's mean over its records times
    its records per record of the wrapper's rarest kernel (one a launch).
    A wrapper whose kernels the trace does not hold fails the run."""
    pat = re.compile(rf"\b{name}_(\w+_)?kernel\b")
    hits = [k for k in ms if pat.search(k)]
    assert hits, f"the profiler's trace holds no kernel of {name}: {sorted(ms)}"
    n_launch = min(ms.records[k] for k in hits)
    return sum(ms[k] * ms.records[k] for k in hits) / n_launch


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def resolve_wide_other_rows(toks: torch.Tensor, sts: torch.Tensor,
                            rows: torch.Tensor, record: dict,
                            card: str) -> None:
    """``resolve_wide`` on the fixture's own tokens at two other row
    lengths, against its plain version and the bytes already resolved: the
    first 32 KiB of every block (a match there copies from there), and
    pairs of blocks as rows of 256 KiB (sources move with their bytes), too
    long for shared memory, so that the kernel keeps them in its output
    array.  Adds both error maxima to ``record``."""
    from zlibes_tpu_torch.ops import wide_kernel as wk

    Cb, nsubb, pad = toks.shape
    short = 32768 // wk.SUB
    pairs = Cb // 2
    cases = {
        "32 KiB rows": (toks[:, :short].contiguous(),
                        sts[:, :short].contiguous(),
                        rows[:, : short * wk.SUB]),
        "256 KiB rows": (toks[: 2 * pairs].reshape(pairs, 2 * nsubb, pad),
                         sts[: 2 * pairs].reshape(pairs, 2 * nsubb, pad),
                         rows[: 2 * pairs].reshape(pairs, -1)),
    }
    assert short * wk.SUB <= wk.RESOLVE_SMEM_ROW < 2 * nsubb * wk.SUB
    for name, (t, st, want) in cases.items():
        got = wk.resolve_wide(t, st)
        torch.cuda.synchronize()
        got_p = wk.resolve_wide_plain(t, st)
        assert torch.equal(got, got_p), f"resolve_wide != plain at {name}"
        assert torch.equal(got, want), f"resolve_wide wrong bytes at {name}"
        err = max_abs_err(got, got_p)
        record["max_abs_err"] = max(record["max_abs_err"], err)
        ms = cuda_ms(lambda: wk.resolve_wide(t, st))
        print(f"kernel resolve_wide at {name} {list(got.shape)}: exact vs "
              f"plain and the fixture's bytes (max_abs_err {err}), kernel "
              f"{ms:.4f} ms (median of 20) {card}")


def sm_clock_mhz() -> tuple[float, str]:
    """The SM clock as nvidia-smi reads it now (just after a timed run it is
    the clock the run had), and the name of the query."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]), "nvidia-smi clocks.sm"


def lane_steps(tokens: torch.Tensor, count: torch.Tensor,
               match_bit: int) -> torch.Tensor:
    """Steps a decode kernel takes per lane by its pairing rule (a step is
    one token, or two when both are literals), leaving out its rare
    one-token cases, so a lower estimate."""
    T = tokens.shape[0]
    steps = torch.zeros_like(count)
    open_lit = torch.zeros_like(count, dtype=torch.bool)
    for t in range(T):
        valid = count > t
        lit = valid & ((tokens[t] & match_bit) == 0)
        second = lit & open_lit
        steps += (valid & ~second).to(steps.dtype)
        open_lit = lit & ~second
    return steps


def lane_report(name: str, record: dict, tokens: torch.Tensor,
                counts: torch.Tensor, match_bit: int, dec_ms: float,
                card: str) -> None:
    """A decode kernel is bound by its longest lane: adds that lane's and
    the mean lane's tokens and steps and the device cycles each costs to
    ``record`` and prints them."""
    mhz, clock_src = sm_clock_mhz()
    counts = counts.long()
    steps = lane_steps(tokens, counts, match_bit)
    cycles = dec_ms * 1e-3 * mhz * 1e6
    # the longest lane of each warp of 32 lanes, which the warp waits for
    padded = steps.new_zeros(-(-steps.numel() // 32) * 32)
    padded[: steps.numel()] = steps
    warp_steps = padded.reshape(-1, 32).max(dim=1).values.float()
    record.update(
        longest_lane_tokens=int(counts.max()),
        mean_lane_tokens=float(counts.float().mean()),
        longest_lane_steps=int(steps.max()),
        mean_lane_steps=float(steps.float().mean()),
        mean_warp_longest_steps=float(warp_steps.mean()), sm_mhz=mhz,
        cycles_per_token=cycles / int(counts.max()),
        cycles_per_step=cycles / int(steps.max()))
    r = record
    print(f"{name} lanes: longest {r['longest_lane_tokens']} tokens, "
          f"mean {r['mean_lane_tokens']:.2f}, most steps a lane "
          f"{r['longest_lane_steps']} (two literals a step; mean "
          f"{r['mean_lane_steps']:.2f}, mean over warps of the longest "
          f"{r['mean_warp_longest_steps']:.2f}); device "
          f"{dec_ms:.4f} ms at {mhz:.0f} MHz ({clock_src}, read after the "
          f"traced run) = {cycles:.0f} cycles -> "
          f"{r['cycles_per_token']:.1f} cycles a token of the longest lane, "
          f"{r['cycles_per_step']:.1f} a step {card}")


def hold_decode(name: str, got: tuple, want: tuple, T: int) -> int:
    """Assert that a decode kernel's (tokens[, starts], meta) equal the
    plain version's: meta everywhere, tokens and starts where emitted.
    Returns the largest absolute difference (0)."""
    meta, meta_p = got[-1], want[-1]
    emitted = (torch.arange(T, device=meta.device)[:, None]
               < meta_p[0][None, :])
    assert torch.equal(meta, meta_p), f"{name}: meta != plain"
    err = max_abs_err(meta, meta_p)
    for part, a, b in zip(("tokens", "starts"), got[:-1], want[:-1]):
        assert torch.equal(a[emitted], b[emitted]), f"{name}: {part} != plain"
        err = max(err, max_abs_err(a[emitted], b[emitted]))
    return err


def lane_windows_device_ms(words, start_w, width: int, card: str) -> float:
    """Device ms of one stand-alone ``lane_windows`` launch (no pipeline
    launches it, so it is traced on its own)."""
    from zlibes_tpu_torch.ops import turbo_kernel as tk

    ms = profile_pipeline(lambda: tk.lane_windows(words, start_w, width),
                          card, runs=20, quiet=True)
    return device_time(ms, "lane_windows")


def turbo_other_inputs(plan, win: torch.Tensor, records: dict,
                       card: str) -> None:
    """The two turbo inflate kernels against their plain versions on what
    the fixture does not hold: ``decode_turbo`` on 4,096 lanes of random
    bits (errors, overruns, reads past the window) and on the fixture's
    lanes with ``T`` cut to 64 (lanes stopped while active);
    ``resolve_turbo`` on random tokens under random unsorted starts, a tenth
    of the tokens copies of themselves, as 32 chunk rows and as one.  Adds
    the error maxima to ``records``."""
    from test_torch_cuda import garbage_chunks, garbage_lanes
    from zlibes_tpu_torch.ops import turbo_kernel as tk

    gwin, gbit0, gendb = (t.cuda() for t in garbage_lanes(4096))
    cases = {
        "4096 lanes of random bits": (gwin, gbit0, gendb, tk.MAX_TOKENS),
        "the fixture at T=64": (win, plan.bit0, plan.endb, 64),
    }
    for name, (w, b0, eb, T) in cases.items():
        tokens, meta = tk.decode_turbo(w, b0, eb, plan.lt, plan.dt, T)
        torch.cuda.synchronize()
        want = tk.decode_turbo_plain(w, b0, eb, plan.lt, plan.dt, T)
        err = hold_decode(f"decode_turbo on {name}", (tokens, meta), want, T)
        records["decode_turbo"]["max_abs_err"] = max(
            records["decode_turbo"]["max_abs_err"], err)
        print(f"kernel decode_turbo on {name}: exact vs plain (max_abs_err "
              f"{err}); {int(meta[2].sum())} lanes with an error, "
              f"{int(meta[3].sum())} still active, {int(meta[0].sum())} "
              f"tokens {card}")
    assert int(meta[3].sum()) > 0, "T=64 cut no lane"

    for C_rows in (32, 1):
        toks, starts = (t.cuda() for t in garbage_chunks(C_rows))
        match = (toks & tk.TOK_MATCH_BIT) != 0
        dist = (toks >> tk.TOK_DIST_SHIFT) & tk.TOK_DIST_MASK
        assert bool((match & (dist == 0)).any()) and bool((starts < 0).any())
        assert bool((starts[..., 1:] < starts[..., :-1]).any())
        rows = tk.resolve_turbo(toks, starts)
        torch.cuda.synchronize()
        rows_p = tk.resolve_turbo_plain(toks, starts)
        assert torch.equal(rows, rows_p), \
            f"resolve_turbo != plain on garbage (C={C_rows})"
        err = max_abs_err(rows, rows_p)
        records["resolve_turbo"]["max_abs_err"] = max(
            records["resolve_turbo"]["max_abs_err"], err)
        print(f"kernel resolve_turbo on random tokens, unsorted starts and "
              f"self-copies, C={C_rows}: exact vs plain (max_abs_err {err}) "
              f"{card}")


def wide_other_inputs(plan, win: torch.Tensor, record: dict,
                      card: str) -> None:
    """``decode_wide`` against its plain version on what the fixture does
    not hold: random bits under the fixture's tables (errors, overruns,
    codes past the kernel's one-level roots, distances before the block,
    reads past the window), with room for every token and with ``T`` cut to
    5, and the fixture's lanes with ``T`` cut to 16 (lanes stopped while
    active).  Adds the error maxima to ``record``."""
    from test_torch_cuda import garbage_wide_lanes
    from zlibes_tpu_torch.ops import wide_kernel as wk

    garbage = tuple(t.cuda() for t in garbage_wide_lanes(plan.Cb))
    fixture = (win, plan.bit0, plan.endb, plan.base)
    cases = {
        f"{plan.Cb * 128} lanes of random bits": (garbage, 128,
                                                  wk.MAX_TOKENS),
        "random bits at T=5": (garbage, 128, 5),
        "the fixture at T=16": (fixture, plan.LPB, 16),
    }
    for name, (lanes, LPB, T) in cases.items():
        got = wk.decode_wide(*lanes, plan.lt, plan.dt, LPB=LPB, T=T)
        torch.cuda.synchronize()
        want = wk.decode_wide_plain(*lanes, plan.lt, plan.dt, LPB, T)
        err = hold_decode(f"decode_wide on {name}", got, want, T)
        record["max_abs_err"] = max(record["max_abs_err"], err)
        meta = got[-1]
        print(f"kernel decode_wide on {name}: exact vs plain (max_abs_err "
              f"{err}); {int(meta[2].sum())} lanes with an error, "
              f"{int(meta[3].sum())} still active, {int(meta[0].sum())} "
              f"tokens {card}")
    assert int(meta[3].sum()) > 0, "T=16 cut no lane"


def wide_lanes_phase(comp: bytes, index, card: str, records: dict) -> None:
    """``wide_lanes`` on the level-6 fixture and on the fixture tiled nine
    times (an nci-sized stream: 270 coded blocks, 270,225 anchors), each
    exact against its plain version on the CPU, with its device time
    (torch.profiler), CUDA event time, the plain version's time and the
    bound; then ``WidePlan.build`` of the tiled stream on the card, host
    clock.  The tiled record is the kernel's row; the fixture's rides in
    it."""
    from test_torch_wide_lanes import tile
    from zlibes_tpu_torch.codec import wide as wd
    from zlibes_tpu_torch.ops import wide_kernel as wk
    from zlibes_tpu_torch.spec import constants as C

    results = {}
    for what, (c, idx) in (("the fixture", (comp, index)),
                           ("tiled x9", tile(comp, index, 9))):
        ids = [i for i, b in enumerate(idx.blocks)
               if b.btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC) and b.out_len]
        host = [torch.from_numpy(x) for x in wd.anchor_rows(idx, ids)]
        dev = [t.cuda() for t in host]
        LPB = 1024

        def launch():
            return wk.wide_lanes(*dev, LPB)

        got = launch()
        torch.cuda.synchronize()
        want = wk.wide_lanes_plain(*host, LPB)
        for g, w, name in zip(got, want, ("start_w", "bit0", "endb", "base",
                                          "status")):
            assert torch.equal(g.cpu(), w), f"wide_lanes {what}: {name}"
        assert not int(want[-1][0]), f"wide_lanes {what}: a lane flagged"
        dev_ms, n_rec = kernel_event_ms(launch, "wide_lanes")
        r = dict(
            replaces="none: the JAX package builds the lanes on the host, a "
                     "loop over the coded blocks (zlibes_tpu/codec/wide.py)",
            max_abs_err=max(max_abs_err(g.cpu(), w)
                            for g, w in zip(got, want)),
            ms=cuda_ms(launch), device_ms=dev_ms,
            plain_ms=wall_s(lambda: wk.wide_lanes_plain(*host, LPB),
                            runs=3) * 1e3, plain_runs=3,
            shape=[len(ids), LPB],
            note="no Pallas counterpart; plain_ms is the plain version on "
                 "the host's CPU (median of 3), not a device time",
            # read: the anchors and the rows; written: four int32 a lane
            # and the status; ~20 operations a lane
            **bound(nbytes(*dev, *got), 20 * got[0].numel()))
        print(f"kernel wide_lanes, {what} ({len(ids)} blocks, "
              f"{host[0].numel()} anchors, {got[0].numel()} lanes): exact vs "
              f"plain; device {dev_ms:.4f} ms a launch (torch.profiler, "
              f"{n_rec} records), events {r['ms']:.4f} ms (median of 20), "
              f"bound {r['bound_ms']:.5f} ms ({r['bytes']} B), plain "
              f"{r['plain_ms']:.2f} ms (CPU, median of 3) {card}")
        results[what] = r
        plan_ms = wall_s(lambda: wd.WidePlan.build(c, idx, "cuda")) * 1e3
        out_mib = idx.total_out / 2**20
        r["plan_ms"] = plan_ms
        print(f"WidePlan.build, {what} ({out_mib:.1f} MiB out): "
              f"{plan_ms:.2f} ms ({plan_ms / out_mib:.4f} ms/MiB; stream "
              f"words, uploads, decode_tables, wide_lanes, one readback), "
              f"median of 5 (host clock) {card}")
    records["wide_lanes"] = dict(results["tiled x9"],
                                 **{"the fixture": results["the fixture"]})


def wide_phase(corpus: bytes, card: str, records: dict) -> tuple[dict, dict]:
    """The wide (default-profile) path on the level-6 fixture: kernels
    against their plain versions, the public entry points, times and a
    corruption probe.  Adds the wide kernels to ``records``; returns the
    launch counts of the inflate run and the profiler's device ms by
    kernel name."""
    import zlibes_tpu_torch
    from test_torch_fixed_streams import expand, fixed_stream
    from zlibes_tpu_torch import ChecksumError, CorruptError, StreamIndex
    from zlibes_tpu_torch.codec import wide as wd
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops import wide_kernel as wk
    from zlibes_tpu_torch.ops.adler32 import adler32_device

    comp = (GOLDEN / "wide_bench.zz").read_bytes()
    index = StreamIndex.load(GOLDEN / "wide_bench.idx.npz")
    assert index.wide and not index.turbo
    assert zlib.decompress(comp) == corpus, "fixture does not encode the corpus"
    plan = wd.WidePlan.build(comp, index, "cuda")
    L = plan.Cb * plan.LPB
    print(f"wide fixture: corpus {len(corpus)} B, stream {len(comp)} B, "
          f"{len(index.blocks)} blocks ({plan.Cb} coded), "
          f"{index.anchor_bit.size} anchors, L={L} lanes "
          f"(LPB={plan.LPB}), SW={plan.SW} words, T={plan.T}, "
          f"contiguous={plan.contiguous}")
    wide_lanes_phase(comp, index, card, records)

    # -- each kernel against its plain version, at the fixture's shapes
    win = tk.lane_windows(plan.words, plan.start_w, width=plan.SW)
    torch.cuda.synchronize()
    win_p = tk.lane_windows_plain(plan.words, plan.start_w, plan.SW)
    assert torch.equal(win, win_p), "lane_windows(width=SW) != plain"
    lw = records["lane_windows"]
    lw["max_abs_err"] = max(lw["max_abs_err"], max_abs_err(win, win_p))
    lw["wide_ms"] = cuda_ms(lambda: tk.lane_windows(plan.words, plan.start_w,
                                                    width=plan.SW))
    lw["wide_plain_ms"] = cuda_ms(lambda: tk.lane_windows_plain(
        plan.words, plan.start_w, plan.SW), runs=10)
    # ~4 operations an output word (index, two compares, select)
    lw["wide_bound_ms"] = bound(nbytes(plan.words, plan.start_w, win),
                                4 * win.numel())["bound_ms"]
    print(f"kernel lane_windows at width {plan.SW}: exact vs plain, kernel "
          f"{lw['wide_ms']:.4f} ms (median of 20), plain "
          f"{lw['wide_plain_ms']:.4f} ms (median of 10), shape "
          f"{list(win.shape)} {card}")

    # the form the pipeline calls: the kernel stages the windows itself from
    # the stream's words; held against the plain decode of the plain windows
    lane_args = (plan.bit0, plan.endb, plan.base, plan.lt, plan.dt)
    src = (plan.words, plan.start_w)

    def decode(source=src):
        return wk.decode_wide(source, *lane_args, LPB=plan.LPB, SW=plan.SW)

    tokens, starts, meta = decode()
    torch.cuda.synchronize()
    want = wk.decode_wide_plain(win_p, *lane_args, plan.LPB)
    err = hold_decode("decode_wide((words, start_w))",
                      (tokens, starts, meta), want, plan.T)
    # and given the windows (the stand-alone kernel's), as the tests call it
    err = max(err, hold_decode("decode_wide(win)", decode(win), want, plan.T))
    plan.check_meta(meta[:4].cpu().numpy())
    records["decode_wide"] = dict(
        replaces=f"{WIDE_SRC}:388", max_abs_err=err, ms=cuda_ms(decode),
        plain_ms=cuda_ms(lambda: wk.decode_wide_plain(
            tk.lane_windows_plain(*src, plan.SW), *lane_args, plan.LPB),
            runs=3, warmup=1),
        shape=list(tokens.shape), tokens=int(meta[0].sum()),
        plain_runs=3)
    # read: the stream's words, the per-lane arrays and the tables; written:
    # the emitted tokens and starts and the meta rows; ~80 operations a token
    # (bit fetch, two table lookups, the checks)
    n_tok = records["decode_wide"]["tokens"]
    records["decode_wide"].update(bound(
        nbytes(*src, *lane_args, meta) + 2 * 4 * n_tok, 80 * n_tok))
    wide_other_inputs(plan, win, records["decode_wide"], card)

    toks, sts = wd._glue_wide(tokens, starts, meta, plan.Cb, plan.LPB)
    rows = wk.resolve_wide(toks, sts)
    torch.cuda.synchronize()
    rows_p = wk.resolve_wide_plain(toks, sts)
    assert torch.equal(rows, rows_p), "resolve_wide != plain"
    assert rows.reshape(-1)[: plan.total_out].cpu().numpy().tobytes() == corpus
    records["resolve_wide"] = dict(
        replaces=f"{WIDE_SRC}:568", max_abs_err=max_abs_err(rows, rows_p),
        ms=cuda_ms(lambda: wk.resolve_wide(toks, sts)),
        plain_ms=cuda_ms(lambda: wk.resolve_wide_plain(toks, sts), runs=10),
        shape=list(rows.shape),
        # ~50 operations a byte (8 search steps, the state, ~3 jump rounds)
        **bound(nbytes(toks, sts, rows), 50 * rows.numel()))
    resolve_wide_other_rows(toks, sts, rows, records["resolve_wide"], card)
    for name in ("decode_wide", "resolve_wide"):
        r = records[name]
        print(f"kernel {name}: exact vs plain (max_abs_err {r['max_abs_err']}),"
              f" kernel {r['ms']:.4f} ms (median of 20), plain "
              f"{r['plain_ms']:.4f} ms (median of "
              f"{r.get('plain_runs', 10)}), shape {r['shape']} {card}")
    glue_ms = cuda_ms(lambda: wd._glue_wide(tokens, starts, meta, plan.Cb,
                                            plan.LPB))
    flat = rows.reshape(-1)[: plan.total_out]
    adler_ms = cuda_ms(lambda: adler32_device(flat))
    print(f"wide torch ops: glue {glue_ms:.4f} ms, adler32 {adler_ms:.4f} ms,"
          f" median of 20 {card}")

    # -- end to end through the public entry points
    tk.LAUNCHES.clear()
    out = zlibes_tpu_torch.inflate(comp, index=index, device="cuda")
    launches = dict(tk.LAUNCHES)
    assert out == corpus, "wide inflate(device='cuda') output != corpus"
    print(f"wide inflate(device='cuda'): {len(out)} B byte-exact, "
          f"Adler-32 verified on the device; launches {launches}")
    assert launches == {"decode_tables": 1, "wide_lanes": 1,
                        "decode_wide": 1, "resolve_wide": 1}, launches
    for start, length in [(0, 100), (131070, 300), (400000, 80000)]:
        got = zlibes_tpu_torch.inflate_range(comp, index, start, length,
                                             device="cuda")
        assert got == corpus[start : start + length], (start, length)
    spans = zlibes_tpu_torch.inflate_to_device(comp, index, device="cuda")
    assert len(spans) == 1 and spans[0][0].is_cuda
    dev_out, off, n = spans[0]
    assert (off, n) == (0, len(corpus))
    assert dev_out[:n].cpu().numpy().tobytes() == corpus
    print("wide inflate_range: 3 seeks byte-exact; inflate_to_device: one "
          f"CUDA span of {n} B byte-exact")

    trailer = int.from_bytes(comp[-4:], "big")

    def device_pipeline():
        rows = wd.run_wide(plan, check=False)
        return adler32_device(rows.reshape(-1)[: plan.total_out])

    assert int(device_pipeline()) == trailer
    pipe_ms = cuda_ms(device_pipeline)
    call_s = wall_s(lambda: zlibes_tpu_torch.inflate(comp, index=index,
                                                     device="cuda"))
    seek_s = wall_s(lambda: zlibes_tpu_torch.inflate_range(
        comp, index, 131070, 300, device="cuda"))
    plan_s = wall_s(lambda: wd.WidePlan.build(comp, index, "cuda"))
    zlib_s = wall_s(lambda: zlib.decompress(comp))
    n = len(corpus)
    print(f"wide host: WidePlan.build (tables, lane spans, copies to the "
          f"card) {plan_s * 1e3:.2f} ms, median of 5 {card}")
    print(f"wide device pipeline (plan prebuilt, stream on device; decode "
          f"with its windows + glue + resolve + adler32): {pipe_ms:.4f} ms -> "
          f"{n / pipe_ms / 1e6:.3f} GB/s of output, median of 20 {card}")
    print(f"wide whole inflate() call, host to host: {call_s * 1e3:.2f} ms -> "
          f"{n / call_s / 1e9:.3f} GB/s, median of 5 {card}")
    print(f"wide inflate_range seek (300 B across a block boundary, 2 blocks "
          f"decoded): {seek_s * 1e3:.2f} ms, median of 5 {card}")
    print(f"CPython zlib.decompress of the wide stream, one core: "
          f"{zlib_s * 1e3:.2f} ms -> {n / zlib_s / 1e9:.3f} GB/s, median of "
          f"5 (host CPU beside {card})")
    device_ms = profile_pipeline(device_pipeline, card)
    if device_ms:
        busy = device_ms.busy
        print(f"wide untraced device pipeline: device busy {busy:.4f} of "
              f"{pipe_ms:.4f} ms -> idle share {1 - busy / pipe_ms:.3f} "
              f"{card}")
    lane_report("decode_wide", records["decode_wide"], tokens, meta[0],
                wk.TOK_MATCH_BIT, device_time(device_ms, "decode_wide"), card)
    lw["wide_device_ms"] = lane_windows_device_ms(plan.words, plan.start_w,
                                                  plan.SW, card)

    # -- corruption probe: a flipped byte raises or lands in a bit gap; a
    # distance reaching before its block's start raises CorruptError even
    # with an Adler-32 that matches the clipped bytes
    rng = np.random.default_rng(4)
    raised = 0
    for _ in range(6):
        bad = bytearray(comp)
        pos = int(rng.integers(16, len(bad) - 8))
        bad[pos] ^= int(rng.integers(1, 256))
        try:
            got = zlibes_tpu_torch.inflate(bytes(bad), index=index,
                                           device="cuda")
        except (CorruptError, ChecksumError) as exc:
            raised += 1
            print(f"wide corruption at byte {pos}: {type(exc).__name__}")
        else:
            assert got == corpus, f"flip at byte {pos} decoded to wrong bytes"
            print(f"wide corruption at byte {pos}: in a bit gap, output "
                  f"unchanged")
    assert raised >= 4, f"only {raised} of 6 wide corruptions detected"
    tokens_bad = [(3, 1), 97, 98, 99]
    bad_comp, bad_index = fixed_stream([tokens_bad], trailer=zlib.adler32(
        expand(tokens_bad, clip=True)).to_bytes(4, "big"))
    try:
        zlibes_tpu_torch.inflate(bad_comp, index=bad_index, device="cuda")
    except CorruptError as exc:
        print(f"distance before the block's start: CorruptError ({exc})")
    else:
        raise AssertionError("distance before the block's start decoded")
    return launches, device_ms


def select_turbo_last_dispatch(corpus: bytes, cfg, record: dict,
                               card: str) -> None:
    """``select_turbo`` on the corpus' last dispatch, whose blocks past the
    input's end give padded lanes (``seg_len`` 0) and whose last real block
    is short, with ``lazy`` on and off, against its plain version.  Adds the
    error maxima to ``record``."""
    from zlibes_tpu_torch.codec import deflate_pipeline as dp
    from zlibes_tpu_torch.codec.framing import stage_rows
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops.lz77 import find_matches

    N, Bp = cfg.block_size, cfg.blocks_per_dispatch
    nblocks = -(-len(corpus) // N)
    d0 = (nblocks - 1) // Bp * Bp
    blk_np, nv_np = stage_rows(np.frombuffer(corpus, np.uint8), d0,
                               nblocks, N, Bp)
    blk = torch.from_numpy(blk_np).cuda()
    nv = torch.from_numpy(nv_np).cuda()
    matches = find_matches(blk, nv, N=N, S=cfg.probe_words, J=cfg.candidates,
                           reset=cfg.chunk_reset, two_phase=True)
    pv, slen = dp.select_inputs(blk, matches, nv, N)
    padded = int((slen == 0).sum())
    assert padded > 0 and int((slen > 0).sum()) > 0
    for lazy in (True, False):
        toks, cnt = tk.select_turbo(pv, slen, lazy=lazy)
        torch.cuda.synchronize()
        toks_p, cnt_p = tk.select_turbo_plain(pv, slen, lazy)
        assert torch.equal(cnt, cnt_p), \
            f"select_turbo counts != plain ({lazy=})"
        assert torch.equal(toks, toks_p), \
            f"select_turbo tokens != plain ({lazy=})"
        assert not bool(cnt[slen == 0].any())
        err = max(max_abs_err(cnt, cnt_p), max_abs_err(toks, toks_p))
        record["max_abs_err"] = max(record["max_abs_err"], err)
        print(f"kernel select_turbo on the last dispatch ({nblocks - d0} "
              f"blocks of {Bp}, {padded} padded lanes of {slen.numel()}), "
              f"lazy={lazy}: exact vs plain (max_abs_err {err}), "
              f"{int(cnt.sum())} tokens {card}")


def encode_phase(corpus: bytes, card: str,
                 records: dict) -> tuple[dict, dict]:
    """The turbo encoder on the bench corpus: its kernels against their
    plain versions at the first dispatch's shapes, per-stage times, the
    public ``deflate`` with its launch counts, the fixture byte for byte,
    the round trip, whole-call and zlib times and a profiler breakdown.
    Adds the encode kernels to ``records``; returns the launch counts of
    the deflate run and the profiler's device ms by kernel name."""
    import zlibes_tpu_torch
    from zlibes_tpu_torch import CodecConfig, CodecStats, StreamIndex
    from zlibes_tpu_torch.codec import deflate_pipeline as dp
    from zlibes_tpu_torch.codec.framing import stage_rows
    from zlibes_tpu_torch.codec.inflate_pipeline import _block_code_lengths
    from zlibes_tpu_torch.ops import deflate_kernel as dk
    from zlibes_tpu_torch.ops import encode_kernel as ek
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops.entropy import limited_lengths_pair
    from zlibes_tpu_torch.ops.lz77 import find_matches

    gold = (GOLDEN / "turbo_bench.zz").read_bytes()
    gold_index = StreamIndex.load(GOLDEN / "turbo_bench.idx.npz")
    cfg = CodecConfig.turbo()
    N, Bp = cfg.block_size, cfg.blocks_per_dispatch
    nseg = N // cfg.seg_size
    nblocks = -(-len(corpus) // N)
    print(f"encode: corpus {len(corpus)} B, CodecConfig.turbo() (S="
          f"{cfg.probe_words}, J={cfg.candidates}, {N} B blocks, {nblocks} "
          f"blocks, {Bp} a dispatch -> {-(-nblocks // Bp)} dispatches of "
          f"L={Bp * nseg} lanes)")

    # -- the first dispatch, stage by stage, on the card
    blk_np, nv_np = stage_rows(np.frombuffer(corpus, np.uint8), 0,
                               min(Bp, nblocks), N, Bp)
    blk = torch.from_numpy(blk_np).cuda()
    nv = torch.from_numpy(nv_np).cuda()

    def match():
        return find_matches(blk, nv, N=N, S=cfg.probe_words,
                            J=cfg.candidates, reset=cfg.chunk_reset,
                            two_phase=True)

    matches = match()
    pv, slen = dp.select_inputs(blk, matches, nv, N)
    toks, cnt = tk.select_turbo(pv, slen)
    torch.cuda.synchronize()
    toks_p, cnt_p = tk.select_turbo_plain(pv, slen)
    assert torch.equal(cnt, cnt_p), "select_turbo counts != plain"
    assert torch.equal(toks, toks_p), "select_turbo tokens != plain"
    records["select_turbo"] = dict(
        replaces=f"{TURBO_SRC}:712",
        max_abs_err=max(max_abs_err(cnt, cnt_p), max_abs_err(toks, toks_p)),
        ms=cuda_ms(lambda: tk.select_turbo(pv, slen)),
        plain_ms=cuda_ms(lambda: tk.select_turbo_plain(pv, slen), runs=3,
                         warmup=1),
        shape=list(toks.shape), tokens=int(cnt.sum()), plain_runs=3,
        # ~25 operations a position (the parallel token pass), ~4 a token
        **bound(nbytes(pv, slen, toks, cnt),
                25 * pv.numel() + 4 * int(cnt.sum())))
    select_turbo_last_dispatch(corpus, cfg, records["select_turbo"], card)

    tv, td, cnt = dp.select_glue(blk, matches, nv, N, cfg.lazy)
    _, _, valid, ll_freq, d_freq = dk.token_symbols(tv, td, cnt, nseg=nseg)
    ll, dl = _block_code_lengths(gold, gold_index.blocks[0])
    ll_code, d_code = dp._encode_tables(ll, dl)
    lt, dt = (t.cuda() for t in ek.pack_tables(ll_code, ll, d_code, dl))
    f_args = (tv.reshape(-1), td.reshape(-1), valid.int().reshape(-1), lt, dt)
    val, nb = ek.encode_fields(*f_args)
    torch.cuda.synchronize()
    val_p, nb_p = ek.encode_fields_plain(*f_args)
    assert torch.equal(val, val_p), "encode_fields values != plain"
    assert torch.equal(nb, nb_p), "encode_fields bit counts != plain"
    records["encode_fields"] = dict(
        replaces=f"{ENCODE_SRC}:123",
        max_abs_err=max(max_abs_err(val, val_p), max_abs_err(nb, nb_p)),
        ms=cuda_ms(lambda: ek.encode_fields(*f_args)),
        plain_ms=cuda_ms(lambda: ek.encode_fields_plain(*f_args), runs=10),
        shape=list(val.shape),
        # ~60 operations a token (two symbols, two extra-bit fields, merge)
        **bound(nbytes(*f_args, val, nb), 60 * val.numel()))
    for name in ("select_turbo", "encode_fields"):
        r = records[name]
        print(f"kernel {name}: exact vs plain (max_abs_err {r['max_abs_err']}),"
              f" kernel {r['ms']:.4f} ms (median of 20), plain "
              f"{r['plain_ms']:.4f} ms (median of "
              f"{r.get('plain_runs', 10)}), shape {r['shape']} {card}")

    hdr = torch.full((Bp,), 611, dtype=torch.int32, device="cuda")
    R = cfg.pack_row_width()
    eob = int(ll[256])
    stages = {
        "match": match,
        "select": lambda: dp.select_glue(blk, matches, nv, N, cfg.lazy),
        "symbols": lambda: dk.token_symbols(tv, td, cnt, nseg=nseg),
        "adler": lambda: dp.adler_terms(blk, nv),
        "entropy": lambda: limited_lengths_pair(ll_freq.sum(0), d_freq.sum(0),
                                                cfg.max_code_bits),
        "pack": lambda: dk.pack_payload_turbo_dense(
            tv, td, valid, lt, dt, hdr, eob, nseg=nseg, R=R),
    }
    stage_ms = {k: cuda_ms(fn, runs=10) for k, fn in stages.items()}
    print(f"encode stages of one dispatch ({Bp} blocks, {Bp * N} B), CUDA "
          f"events, median of 10: " + ", ".join(f"{k} {v:.4f} ms"
                                       for k, v in stage_ms.items())
          + f" {card}")

    # -- end to end through the public entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    tk.LAUNCHES.clear()
    out = zlibes_tpu_torch.deflate(corpus, config=cfg, device="cuda")
    launches = dict(tk.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20 - base_mb
    assert out == gold, "deflate(device='cuda') != tests/golden/turbo_bench.zz"
    print(f"deflate(device='cuda'): {len(out)} B (ratio "
          f"{len(out) / len(corpus):.4f}), byte-exact with the fixture; "
          f"launches {launches}; peak device memory {peak_mb:.1f} MiB above "
          f"the {base_mb:.1f} MiB held before the call")
    for name in ("select_turbo", "encode_fields"):
        assert launches.get(name, 0) >= 1, f"{name} not launched by deflate"
    stats = CodecStats()
    out2, index = dp.deflate(corpus, with_index=True, config=cfg,
                             stats=stats, device="cuda")
    assert out2 == gold
    assert index.blocks == gold_index.blocks, "index blocks != fixture"
    for f in ("anchor_bit", "anchor_out", "anchor_block"):
        assert np.array_equal(getattr(index, f), getattr(gold_index, f)), f
    assert (index.turbo, index.chunk_reset, index.max_tokens) == \
        (gold_index.turbo, gold_index.chunk_reset, gold_index.max_tokens)
    back = zlibes_tpu_torch.inflate(out, index=index, device="cuda")
    assert back == corpus, "inflate(deflate(corpus)) != corpus"
    print(f"index equals the fixture's ({len(index.blocks)} blocks, "
          f"{index.anchor_bit.size} anchors, max_tokens {index.max_tokens});"
          f" inflate(device='cuda') of the output returns the corpus; "
          f"stages (host clock, queued work) "
          f"{ {k: round(v * 1e3, 2) for k, v in stats.stage_s.items()} } ms")

    n = len(corpus)
    call_s = wall_s(lambda: zlibes_tpu_torch.deflate(corpus, config=cfg,
                                                     device="cuda"))
    z1_s = wall_s(lambda: zlib.compress(corpus, 1))
    z6_s = wall_s(lambda: zlib.compress(corpus, 6))
    print(f"whole deflate() call, host to host: {call_s * 1e3:.2f} ms -> "
          f"{n / call_s / 1e9:.4f} GB/s of input, median of 5 {card}")
    print(f"CPython zlib.compress, one core: level 1 {z1_s * 1e3:.2f} ms -> "
          f"{n / z1_s / 1e9:.4f} GB/s ({len(zlib.compress(corpus, 1))} B), "
          f"level 6 {z6_s * 1e3:.2f} ms -> {n / z6_s / 1e9:.4f} GB/s "
          f"({len(zlib.compress(corpus, 6))} B), median of 5 (host CPU "
          f"beside {card})")
    device_ms = profile_pipeline(
        lambda: zlibes_tpu_torch.deflate(corpus, config=cfg, device="cuda"),
        card, runs=2)
    span_report("turbo encode", device_ms, TURBO_SPANS, TURBO_CALL_SPANS,
                stats.dispatches, card)
    if device_ms:
        busy = device_ms.busy
        print(f"encode: device busy {busy:.4f} of {call_s * 1e3:.2f} ms per "
              f"untraced deflate() call -> idle share "
              f"{1 - busy / (call_s * 1e3):.3f} {card}")
    return launches, device_ms


def hold_select_tokens(args: tuple, kw: dict, what: str, card: str):
    """``select_tokens`` on the card against its plain version (run once:
    it is ``SEG_SIZE`` eager steps): counts equal, tokens equal in
    [0, count) and zero past it.  Returns (max_abs_err, kernel outputs, the
    plain run's ms by CUDA events)."""
    from zlibes_tpu_torch.ops import lz77

    tv, td, cnt = lz77.select_tokens(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    tv_p, td_p, cnt_p = lz77.select_tokens_plain(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    assert torch.equal(cnt, cnt_p), f"select_tokens counts != plain ({what})"
    past = torch.arange(tv.shape[1], device=tv.device)[None, :] >= cnt[:, None]
    assert torch.equal(tv, tv_p) and torch.equal(td, td_p), \
        f"select_tokens tokens != plain ({what})"
    assert not bool(tv[past].any()) and not bool(td[past].any())
    err = max(max_abs_err(cnt, cnt_p), max_abs_err(tv, tv_p),
              max_abs_err(td, td_p))
    print(f"kernel select_tokens on {what}: exact vs plain (max_abs_err "
          f"{err}), {int(cnt.sum())} tokens in {cnt.numel()} lanes, longest "
          f"{int(cnt.max())}, {int((cnt == 0).sum())} empty {card}")
    return err, (tv, td, cnt), start.elapsed_time(end)


def select_tokens_lanes(what: str, args: tuple, kw: dict, got: tuple,
                        call, record: dict, card: str) -> None:
    """The kernel's procedure in numpy (``select_tokens_model``) on a
    dispatch the kernel ran: its tokens must be the kernel's; prints the
    device time a launch of ``call`` (``kernel_event_ms``) and in SM cycles
    beside the lanes' tokens, the fix-up rounds, the most walks of a piece
    and the longest speculative walk, and adds them to ``record`` under
    ``what``."""
    from test_torch_contract_cases import select_tokens_model

    device_ms, n_events = kernel_event_ms(call, "select_tokens")
    tv, td, cnt, stats = select_tokens_model(*(a.cpu().numpy() for a in args),
                                             **kw)
    for a, b in zip((tv, td, cnt), got):
        assert np.array_equal(a, b.cpu().numpy()), \
            f"select_tokens_model != the kernel ({what})"
    live = cnt > 0
    mhz, src = sm_clock_mhz()
    rounds, walks, longest = (int(x) for x in stats[live].max(0))
    record[what] = dict(
        device_ms=device_ms, sm_mhz=mhz, cycles=device_ms * mhz * 1e3,
        longest_lane_tokens=int(cnt.max()),
        mean_lane_tokens=float(cnt[live].mean()), lanes=int(cnt.size),
        empty_lanes=int((~live).sum()), rounds=rounds,
        median_rounds=float(np.median(stats[live, 0])), most_walks=walks,
        longest_walk=longest)
    r = record[what]
    print(f"select_tokens on {what}: device {device_ms:.4f} ms a launch "
          f"(torch.profiler, mean of {n_events} launches) = "
          f"{r['cycles']:.0f} cycles at {mhz:.0f} MHz "
          f"({src}); {r['lanes']} lanes, {r['empty_lanes']} empty, longest "
          f"{r['longest_lane_tokens']} tokens (mean of the others "
          f"{r['mean_lane_tokens']:.1f}); fix-up rounds: most {rounds} "
          f"(median {r['median_rounds']:.0f}), most walks a piece {walks}, "
          f"longest speculative walk {longest} tokens (the launch's "
          f"cycles over it: {r['cycles'] / max(longest, 1):.1f} a token; "
          f"select_tokens_model, exact with the kernel) {card}")


def hold_select_chain_cases(card: str) -> int:
    """``select_tokens`` against its plain version on the cases that stress
    the kernel's pieces, walks and fix-up rounds (``SELECT_CHAIN_CASES`` of
    ``test_torch_contract_cases``), each also holding its own features;
    returns the largest error."""
    from test_torch_contract_cases import (SELECT_CHAIN_CASES,
                                           check_select_chain_case,
                                           select_chain_inputs)

    err = 0
    for case, (_, _, _, holds) in SELECT_CHAIN_CASES.items():
        args, kw = select_chain_inputs(case)
        e, (tv, td, cnt), _ = hold_select_tokens(
            tuple(a.cuda() for a in args), kw, f"{case} ({holds})", card)
        check_select_chain_case(case, tv.cpu().numpy(), td.cpu().numpy(),
                                cnt.cpu().numpy())
        err = max(err, e)
    return err


def general_phase(corpus: bytes, card: str,
                  records: dict) -> tuple[dict, dict]:
    """The general encoder (level 6) on the bench corpus: ``select_tokens``
    against its plain version on real and random matches, per-stage times
    of one dispatch, the public ``deflate`` with its launch counts, the
    wide fixture byte for byte and its index field for field, the round
    trips, other levels and a dictionary on raw.bin, ``deflate_indexed``
    and ``backend="refmodel"``, whole-call and zlib times and a profiler
    breakdown.  Adds ``select_tokens`` and ``block_tables`` to
    ``records``; returns the launch counts of the deflate run and the
    profiler's device ms by kernel name."""
    import zlibes_tpu_torch
    from zlibes_tpu_torch import CodecConfig, CodecStats, StreamIndex
    from zlibes_tpu_torch.codec import deflate_pipeline as dp
    from zlibes_tpu_torch.codec.framing import stage_rows
    from zlibes_tpu_torch.ops import block_tables as bt
    from zlibes_tpu_torch.ops import deflate_kernel as dk
    from zlibes_tpu_torch.ops import lz77
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops import wide_kernel as wk

    gold = (GOLDEN / "wide_bench.zz").read_bytes()
    gold_index = StreamIndex.load(GOLDEN / "wide_bench.idx.npz")
    cfg = CodecConfig.from_level(6)
    N, Bp, SEG = cfg.block_size, cfg.blocks_per_dispatch, cfg.seg_size
    nseg = N // SEG
    arr = np.frombuffer(corpus, np.uint8)
    nblocks = -(-arr.size // N)
    print(f"general encode: corpus {len(corpus)} B, CodecConfig.from_level(6)"
          f" (S={cfg.probe_words}, J={cfg.candidates}, {N} B blocks, "
          f"{nblocks} blocks, {Bp} a dispatch -> {-(-nblocks // Bp)} "
          f"dispatches of L={Bp * nseg} lanes of {SEG})")

    def dispatch(d0, arr=arr):
        n_blocks = -(-arr.size // N)
        blk_np, nv_np = stage_rows(arr, d0, min(n_blocks, d0 + Bp), N, Bp)
        blk = torch.from_numpy(blk_np).cuda()
        nv = torch.from_numpy(nv_np).cuda()
        return blk, nv, lz77.find_matches(blk, nv, N=N, S=cfg.probe_words,
                                          J=cfg.candidates)

    # -- select_tokens against its plain version: the second dispatch's real
    # matches (padded blocks, a ragged last block), then random matches
    d_last = (nblocks - 1) // Bp * Bp
    blk, nv, matches = dispatch(d_last)
    assert int((nv == 0).sum()) > 0 and int(nv.max()) == N
    assert 0 < int(nv[nblocks - d_last - 1]) < N
    kw = dict(N=N, SEG_SIZE=SEG, lazy=cfg.lazy, start=0)
    err, _, _ = hold_select_tokens(
        (blk, matches, nv), kw, f"the last dispatch ({nblocks - d_last} "
        f"blocks of {Bp})", card)
    g = torch.Generator().manual_seed(11)
    for seg, start, lazy in [(s_, st, lz) for s_ in (4096, 1024)
                             for st in (0, 32768) for lz in (True, False)]:
        n_r = start + 32768
        data_r = torch.randint(0, 256, (3, n_r + 8), generator=g,
                               dtype=torch.uint8)
        ml = torch.randint(0, 259, (3, n_r), generator=g)
        ml = torch.where(torch.rand((3, n_r), generator=g) < 0.5, 0, ml)
        m_r = ((ml << 16) | torch.randint(1, 32769, (3, n_r),
                                          generator=g)).int()
        nv_r = torch.tensor([n_r, start + 20000 + seg // 3, start],
                            dtype=torch.int32)
        e, _, _ = hold_select_tokens(
            (data_r.cuda(), m_r.cuda(), nv_r.cuda()),
            dict(N=n_r, SEG_SIZE=seg, lazy=lazy, start=start),
            f"random matches, SEG {seg}, start {start}, lazy={lazy}", card)
        err = max(err, e)
    err = max(err, hold_select_chain_cases(card))

    # -- the first (full) dispatch, stage by stage, on the card
    blk, nv, matches = dispatch(0)
    e, (tv, td, cnt), plain_ms = hold_select_tokens(
        (blk, matches, nv), kw, "the first dispatch", card)
    n_tok = int(cnt.sum())
    records["select_tokens"] = dict(
        replaces="zlibes_tpu/ops/lz77.py:295",
        note="the reference's select_tokens is an XLA while_loop of up to "
             "SEG_SIZE steps, not a pallas_call; its plain PyTorch version "
             "is SEG_SIZE eager steps (plain_ms is one run)",
        max_abs_err=max(err, e),
        ms=cuda_ms(lambda: lz77.select_tokens(blk, matches, nv, **kw)),
        plain_ms=plain_ms, plain_runs=1, shape=list(tv.shape), tokens=n_tok,
        longest_lane_tokens=int(cnt.max()),
        mean_lane_tokens=float(cnt.float().mean()),
        # read: the matches, the blocks' bytes, the counts; written: both
        # token rows and the counts; ~20 operations a position (the parallel
        # token pass), ~4 a token (the walk)
        **bound(nbytes(matches, nv, tv, td, cnt) + matches.numel(),
                20 * matches.numel() + 4 * n_tok))
    r = records["select_tokens"]
    print(f"kernel select_tokens: exact vs plain (max_abs_err "
          f"{r['max_abs_err']}), kernel {r['ms']:.4f} ms (median of 20), "
          f"plain {r['plain_ms']:.1f} ms (one run), shape {r['shape']} {card}")

    lsym, dsym, valid, ll_freq, d_freq = dk.token_symbols(tv, td, cnt,
                                                          nseg=nseg)
    # -- block_tables against its plain version, the host planner, on the
    # first dispatch's histograms (16 full blocks, none the last)
    tab_args = (ll_freq, d_freq, nv, Bp, -1)
    tables = bt.block_tables(*tab_args)
    torch.cuda.synchronize()
    plain_args = (ll_freq.cpu(), d_freq.cpu(), nv.cpu(), Bp, -1)
    plain = bt.block_tables(*plain_args)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(tables, plain)), \
        "block_tables != its plain version"
    records["block_tables"] = dict(
        replaces="none: the JAX package plans each block on the host "
                 "(_plan_block in zlibes_tpu/codec/deflate_pipeline.py)",
        note="no Pallas counterpart; plain_ms is the host planner on the "
             "host clock (median of 3), not a device time",
        max_abs_err=max(max_abs_err(a.cpu().long(), b.long())
                        for a, b in zip(tables, plain)),
        ms=cuda_ms(lambda: bt.block_tables(*tab_args)),
        plain_ms=wall_s(lambda: bt.block_tables(*plain_args), runs=3) * 1e3,
        plain_runs=3, shape=[Bp, ll_freq.shape[1] + d_freq.shape[1]],
        # the bound counts bytes alone: the kernel is latency-bound, a few
        # thousand dependent steps a block
        **bound(nbytes(ll_freq, d_freq, nv, *tables), 0))
    r = records["block_tables"]
    print(f"kernel block_tables: exact vs plain (max_abs_err "
          f"{r['max_abs_err']}), kernel {r['ms']:.4f} ms (median of 20), "
          f"plain (host planner) {r['plain_ms']:.2f} ms (median of 3), "
          f"{Bp} blocks, btypes {tables[6][:, 0].tolist()} {card}")
    tables, info = tables[:6], tables[6].cpu().numpy()
    W = (15 * N + 4096) // 32

    def pack():
        return dk.pack_payload(tv, td, lsym, dsym, valid, *tables, nseg=nseg,
                               W=W, sub_every=wk.SUB)

    words, payload_end, _, _, _ = pack()
    used = [0 if bty == 0 else (int(pe) + int(eob) + 31) // 32 + 1
            for pe, bty, eob in zip(payload_end.tolist(), info[:, 0],
                                    info[:, 2])]   # 0: stored
    flat_idx = torch.cat([torch.arange(u) + i * W
                          for i, u in enumerate(used)]).cuda()
    stages = {
        "match": lambda: lz77.find_matches(blk, nv, N=N, S=cfg.probe_words,
                                           J=cfg.candidates),
        "select": lambda: lz77.select_tokens(blk, matches, nv, **kw),
        "symbols": lambda: dk.token_symbols(tv, td, cnt, nseg=nseg),
        "tables": lambda: bt.block_tables(*tab_args),
        "pack": pack,
        "gather": lambda: dk.gather_compressed(words.reshape(-1), flat_idx),
    }
    stage_ms = {k: cuda_ms(fn, runs=5, warmup=1) for k, fn in stages.items()}
    print(f"general encode stages of one dispatch ({Bp} blocks, {Bp * N} B), "
          f"CUDA events, median of 5: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in stage_ms.items())
          + f"; the host planner's tables of the dispatch "
          f"{r['plain_ms']:.2f} ms (host clock) {card}")

    # -- end to end through the public entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    tk.LAUNCHES.clear()
    out = zlibes_tpu_torch.deflate(corpus, level=6, device="cuda")
    launches = dict(tk.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20 - base_mb
    assert out == gold, "deflate(level=6) != tests/golden/wide_bench.zz"
    assert launches == {"select_tokens": -(-nblocks // Bp),
                        "block_tables": -(-nblocks // Bp)}, launches
    print(f"deflate(level=6, device='cuda'): {len(out)} B (ratio "
          f"{len(out) / len(corpus):.4f}), byte-exact with the fixture; "
          f"launches {launches}; peak device memory {peak_mb:.1f} MiB above "
          f"the {base_mb:.1f} MiB held before the call")
    stats = CodecStats()
    out2, index = dp.deflate(corpus, with_index=True, level=6, stats=stats,
                             device="cuda")
    assert out2 == gold
    assert stats.device_tables == nblocks, (stats.device_tables, nblocks)
    assert index.blocks == gold_index.blocks, "index blocks != fixture"
    for f in ("anchor_bit", "anchor_out", "anchor_block"):
        assert np.array_equal(getattr(index, f), getattr(gold_index, f)), f
    assert (index.wide, index.turbo, index.chunk_reset, index.max_tokens) == \
        (gold_index.wide, gold_index.turbo, gold_index.chunk_reset,
         gold_index.max_tokens)
    assert zlib.decompress(out) == corpus
    tk.LAUNCHES.clear()
    back = zlibes_tpu_torch.inflate(out, index=index, device="cuda")
    assert back == corpus, "inflate(deflate(corpus, level=6)) != corpus"
    assert dict(tk.LAUNCHES) == {"decode_tables": 1, "wide_lanes": 1,
                                 "decode_wide": 1, "resolve_wide": 1}, \
        dict(tk.LAUNCHES)
    host_ms = (stats.stage_s["tables"] + stats.stage_s["splice"]) * 1e3
    print(f"index equals the fixture's ({len(index.blocks)} blocks, "
          f"{index.anchor_bit.size} anchors); CPython zlib.decompress and "
          f"inflate(index=, device='cuda') ({dict(tk.LAUNCHES)}) return the "
          f"corpus; stages (host clock, queued work) "
          f"{ {k: round(v * 1e3, 2) for k, v in stats.stage_s.items()} } ms; "
          f"the host's share, tables + splice: {host_ms:.2f} ms {card}")

    # -- the other levels and a preset dictionary, on raw.bin: sizes do not
    # depend on the hardware
    raw = (GOLDEN / "raw.bin").read_bytes()
    sizes = {}
    for level in (0, 1, 6, 9):
        comp, idx = dp.deflate(raw, with_index=True, level=level,
                               device="cuda")
        assert zlib.decompress(comp) == raw, f"CPython refuses level {level}"
        assert zlibes_tpu_torch.inflate(comp, index=idx,
                                        device="cuda") == raw
        assert idx.wide == (level > 0)
        sizes[level] = len(comp)
    assert sizes[0] > len(raw) and (sizes[6], sizes[9]) == (191419, 188386), \
        sizes
    zdict = corpus[len(raw) : len(raw) + 32768]
    comp, idx = dp.deflate(raw, with_index=True, level=6, dictionary=zdict,
                           device="cuda")
    assert comp[1] & 0x20 and not idx.wide
    assert zlib.decompressobj(zdict=zdict).decompress(comp) == raw
    assert zlibes_tpu_torch.inflate(comp, dictionary=zdict,
                                    device="cuda") == raw
    assert zlibes_tpu_torch.inflate(comp, index=idx, dictionary=zdict,
                                    device="cuda") == raw
    assert len(comp) < sizes[6], "the dictionary did not help"
    print(f"raw.bin ({len(raw)} B) on the card, each accepted by CPython and "
          f"by the port's inflate: level 0 {sizes[0]} B, level 1 {sizes[1]} "
          f"B, level 6 {sizes[6]} B, level 9 {sizes[9]} B, level 6 with a "
          f"32 KiB dictionary {len(comp)} B (FDICT)")
    part = raw[:50000]
    comp_i, idx_i = zlibes_tpu_torch.deflate_indexed(part, device="cuda")
    assert idx_i.wide and zlib.decompress(comp_i) == part
    assert zlibes_tpu_torch.inflate_range(comp_i, idx_i, 40000, 300,
                                          device="cuda") == part[40000:40300]
    host = zlibes_tpu_torch.deflate(part, backend="refmodel")
    assert zlib.decompress(host) == part
    assert zlibes_tpu_torch.inflate(host, backend="refmodel") == part
    print(f"deflate_indexed(device='cuda') of {len(part)} B: {len(comp_i)} B "
          f"with a wide index, a seek byte-exact; backend='refmodel' (host "
          f"model): {len(host)} B, round trip byte-exact")

    # -- times
    n = len(corpus)
    call_s = wall_s(lambda: zlibes_tpu_torch.deflate(corpus, level=6,
                                                     device="cuda"))
    z6_s = wall_s(lambda: zlib.compress(corpus, 6))
    print(f"whole deflate(level=6) call, host to host: {call_s * 1e3:.2f} ms "
          f"-> {n / call_s / 1e9:.4f} GB/s of input, median of 5 {card}")
    print(f"CPython zlib.compress(level=6), one core: {z6_s * 1e3:.2f} ms -> "
          f"{n / z6_s / 1e9:.4f} GB/s ({len(zlib.compress(corpus, 6))} B), "
          f"median of 5 (host CPU beside {card})")
    device_ms = profile_pipeline(
        lambda: zlibes_tpu_torch.deflate(corpus, level=6, device="cuda"),
        card, runs=2)
    span_report("level-6 encode", device_ms, GENERAL_SPANS,
                GENERAL_CALL_SPANS, -(-nblocks // Bp), card)
    if device_ms:
        busy = device_ms.busy
        print(f"general encode: device busy {busy:.4f} of {call_s * 1e3:.2f} "
              f"ms per untraced deflate(level=6) call -> idle share "
              f"{1 - busy / (call_s * 1e3):.3f} {card}")
    records["block_tables"]["device_ms"] = device_time(device_ms,
                                                       "block_tables")
    print(f"block_tables: device {records['block_tables']['device_ms']:.4f} "
          f"ms a launch (torch.profiler), bound "
          f"{records['block_tables']['bound_ms']:.4f} ms "
          f"({records['block_tables']['bytes']} B), "
          f"{launches['block_tables']} launches a call {card}")
    r = records["select_tokens"]
    r["device_ms"] = device_time(device_ms, "select_tokens")
    print(f"select_tokens: device {r['device_ms']:.4f} ms a launch "
          f"(torch.profiler), bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({r['bytes']} B), {launches['select_tokens']} launches a call, "
          f"longest lane {r['longest_lane_tokens']} tokens (mean "
          f"{r['mean_lane_tokens']:.1f}), library call: none {card}")
    select_tokens_lanes("the bench dispatch", (blk, matches, nv), kw,
                        (tv, td, cnt), lambda: lz77.select_tokens(
                            blk, matches, nv, **kw), r, card)

    # -- data nobody can compress: 1 MiB of seeded random bytes, one
    # dispatch of 8 blocks (8 of its 16 rows padded), nearly all literals
    rnd = np.random.default_rng(INCOMPRESSIBLE_SEED).integers(
        0, 256, 1 << 20, dtype=np.uint8)
    comp_r = zlibes_tpu_torch.deflate(rnd.tobytes(), level=6, device="cuda")
    assert zlib.decompress(comp_r) == rnd.tobytes(), \
        "deflate(random, level=6) does not come back through CPython"
    r_blk, r_nv, r_matches = dispatch(0, rnd)
    e, got, _ = hold_select_tokens((r_blk, r_matches, r_nv), kw,
                                   "1 MiB of random bytes", card)
    r["max_abs_err"] = max(r["max_abs_err"], e)
    print(f"deflate(1 MiB of random bytes, level=6, device='cuda'): "
          f"{len(comp_r)} B, CPython zlib.decompress returns the input")
    select_tokens_lanes("the incompressible dispatch",
                        (r_blk, r_matches, r_nv), kw, got,
                        lambda: lz77.select_tokens(r_blk, r_matches, r_nv,
                                                   **kw), r, card)
    return launches, device_ms


def hold_tokens(what: str, got: tuple, want: tuple, T: int,
                card: str) -> int:
    """``decode_tokens`` on the card against its plain version
    (``check_decode_tokens``), printed.  Returns the largest absolute
    difference (0)."""
    from test_torch_contract_cases import check_decode_tokens

    err = check_decode_tokens(got, want, T, f"({what})")
    print(f"kernel decode_tokens on {what}: exact vs plain (max_abs_err "
          f"{err}); {int(want[2].sum())} tokens in {want[2].numel()} lanes, "
          f"{int(want[5].sum())} with an error, {int(want[4].sum())} still "
          f"active {card}")
    return err


def hold_resolve(what: str, args: tuple, card: str,
                 want_bytes: bytes | None = None) -> tuple[int, bool]:
    """``resolve_global`` on the card against its plain version on the same
    inputs: bytes and error flag equal.  Returns (max_abs_err, err)."""
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    out, err = ik.resolve_global(*args)
    torch.cuda.synchronize()
    out_p, err_p = ik.resolve_global_plain(*args)
    assert torch.equal(out, out_p), f"resolve_global != plain ({what})"
    assert bool(err) == bool(err_p), f"resolve_global err != plain ({what})"
    if want_bytes is not None:
        assert out.cpu().numpy().tobytes() == want_bytes, what
    e = max_abs_err(out, out_p)
    print(f"kernel resolve_global on {what}: exact vs plain (max_abs_err "
          f"{e}), err {bool(err)}, {out.numel()} B {card}")
    return e, bool(err)


def hold_walk_and_span_cases(records: dict, card: str) -> None:
    """Both generic kernels on the contract cases of their designs
    (``test_torch_contract_cases``): ``decode_tokens`` on a warp of 32
    distinct table rows, on codes of 12-15 bits with 13-bit distance extras,
    on tokens ending on and one bit past a lane's end, and on one lane of
    65,800 tokens resumed after 65,536 (held against the case's tokens: its
    plain version takes a launch a tensor op a token); ``resolve_global`` on
    a distance-1 run of 1 MiB, on copies across tile and lane boundaries, on
    overlapping copies and on one (n, 1) lane of 1,050,000 tokens behind a
    32 KiB prefix, each against its plain version and the case's bytes."""
    from test_torch_contract_cases import (RESOLVE_SPAN_CASES, WALK_CASES,
                                           check_decode_tokens, run_walk_case,
                                           span_case)
    from zlibes_tpu_torch.ops import inflate_kernel as ik

    for case in WALK_CASES:
        errs = [0]

        def decode(*args):
            *lanes, T = args
            lanes = [torch.as_tensor(np.asarray(a)).cuda() for a in lanes]
            got = ik.decode_tokens(*lanes, T=T)
            torch.cuda.synchronize()
            if case != "scan_lane":
                errs.append(check_decode_tokens(
                    got, ik.decode_tokens_plain(*lanes, T), T, case))
            return got

        calls = run_walk_case(case, decode)
        r = records["decode_tokens"]
        r["max_abs_err"] = max(r["max_abs_err"], *errs)
        print(f"kernel decode_tokens on the walk case {case}: the case's "
              f"tokens in {len(calls)} call(s)"
              + ("" if case == "scan_lane" else ", exact vs plain")
              + f" (max_abs_err {max(errs)}) {card}")
    for case in RESOLVE_SPAN_CASES:
        args, want = span_case(case)
        args = tuple(torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                     else a for a in args)
        e, flagged = hold_resolve(f"the span case {case}", args, card,
                                  want.tobytes())
        assert not flagged
        r = records["resolve_global"]
        r["max_abs_err"] = max(r["max_abs_err"], e)


def generic_phase(corpus: bytes, card: str,
                  records: dict) -> tuple[dict, dict]:
    """The generic indexed decode and the un-indexed device decode on two
    CPython streams of the corpus: level 6 with a full flush every 32 KiB
    (self-contained, ``build_index``) and ``zlib.compress(corpus, 6)``
    (chained).  Both kernels against their plain versions (the flushed
    stream's group, ``T`` cut so that lanes resume, random bits, a resolve
    behind a 32 KiB prefix and one reaching below 0, the scan's single lane
    on a 50 KB stream), the entry points with their launch counts, the
    stored block between dynamic ones, a corruption probe, times and a
    profiler breakdown.  Adds both kernels to ``records``; returns the
    launch counts of the ``inflate_to_device`` run and the profiler's
    device ms by kernel name."""
    import zlibes_tpu_torch
    from test_torch_contract_cases import (garbage_generic_lanes,
                                           random_generic_tokens,
                                           zlib_flushed)
    from zlibes_tpu_torch import ChecksumError, CorruptError
    from zlibes_tpu_torch.codec import inflate_pipeline as ip
    from zlibes_tpu_torch.ops import inflate_kernel as ik
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops.adler32 import adler32_device
    from zlibes_tpu_torch.runtime import native

    t0 = time.perf_counter()
    flush = zlib_flushed(corpus, 32768)
    chained = zlib.compress(corpus, 6)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_index = zlibes_tpu_torch.build_index(flush)
    c_index = zlibes_tpu_torch.build_index(chained)
    index_s = time.perf_counter() - t0
    assert f_index.self_contained and not c_index.self_contained
    for name, comp, idx in (("32 KiB flushes", flush, f_index),
                            ("no flush", chained, c_index)):
        print(f"generic fixture ({name}): {len(comp)} B, "
              f"{len(idx.blocks)} blocks, {idx.anchor_bit.size} anchors, "
              f"self_contained={idx.self_contained}")
    print(f"generic fixtures: both streams made by CPython zlib in "
          f"{make_s:.2f} s, both indexes by build_index in {index_s:.3f} s "
          f"(host clock)")

    # -- decode_tokens against its plain version on the flushed stream's
    # one group
    plans = ip.plan_groups(flush, f_index, "cuda")
    assert len(plans) == 1
    p = plans[0]
    stream = ip._Stream(flush, "cuda")
    lanes = (stream.words, p.lt, p.dt, p.rows, p.bit0, p.endb, p.active)

    def decode(T=p.T):
        return ik.decode_tokens(*lanes, T=T)

    got = decode()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = ik.decode_tokens_plain(*lanes, p.T)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = hold_tokens(f"the 32 KiB-flush group (B={p.B}, T={p.T})", got,
                      want, p.T, card)
    count = got[2]
    assert not bool(got[5].any()) and not bool(got[4].any())
    assert np.array_equal(got[3].cpu().numpy(), p.lane_end)
    # T cut to 512: lanes stop while active and resume, call after call
    bit0, active, calls = p.bit0, p.active, 0
    while bool(active.any()):
        cut = ik.decode_tokens(*lanes[:4], bit0, p.endb, active, T=512)
        torch.cuda.synchronize()
        cut_p = ik.decode_tokens_plain(*lanes[:4], bit0, p.endb, active, 512)
        err = max(err, hold_tokens(f"the group at T=512, call {calls + 1}",
                                   cut, cut_p, 512, card))
        bit0, active = cut[3], cut[4]
        calls += 1
    assert calls > 1 and np.array_equal(bit0.cpu().numpy(), p.lane_end)
    g_lanes = tuple(t.cuda() for t in garbage_generic_lanes(4096, seed=5))
    g_got = ik.decode_tokens(*g_lanes, T=64)
    torch.cuda.synchronize()
    g_want = ik.decode_tokens_plain(*g_lanes, 64)
    err = max(err, hold_tokens("4096 lanes of random bits", g_got, g_want,
                               64, card))
    assert bool(g_want[5].any()) and not bool(g_want[5].all())
    n_tok = int(count.sum())
    records["decode_tokens"] = dict(
        replaces="zlibes_tpu/ops/inflate_kernel.py:62",
        note="the reference's decode_tokens is an XLA while_loop, not a "
             "pallas_call; its plain PyTorch version is one eager step a "
             "token of the longest lane (plain_ms is one run); the kernel "
             "is a flatten launch and the walk, counted as one",
        max_abs_err=err, ms=cuda_ms(decode), plain_ms=plain_ms, plain_runs=1,
        shape=list(got[0].shape), tokens=n_tok,
        longest_lane_tokens=int(count.max()),
        mean_lane_tokens=float(count.float().mean()),
        # read: the stream's words, the tables, the per-lane arrays;
        # written: the emitted tokens and starts, the per-lane results;
        # ~40 operations a token (bit fetch, two table lookups, the checks)
        **bound(nbytes(*lanes, *got[2:]) + 2 * 4 * n_tok, 40 * n_tok))

    # -- resolve_global against its plain version: the group from byte 0
    # at the shape the main path gives it (run_group(check=False), as
    # inflate_to_device calls it, passes the decoder's whole (T, B) arrays,
    # whose slots at or past a lane's count were never written), then with
    # those slots filled with random words, then trimmed to the occupied
    # rows (as run_group(check=True) passes them); then from its first lane
    # past 32 KiB behind the 32 KiB before it; then random lanes behind a
    # 32 KiB prefix and reaching below 0
    empty = stream.bytes[:0]
    r_args = (got[0], got[1], count, p.out_base, p.d_total, empty)
    rerr, _ = hold_resolve(
        f"the 32 KiB-flush group, tokens (T, B) = {tuple(got[0].shape)} as "
        f"the main path passes them", r_args, card, corpus)
    unwritten = ~(torch.arange(p.T, device="cuda")[:, None]
                  < count.long()[None, :])
    noise = torch.randint(-2**31, 2**31 - 1, (2, p.T, p.B), dtype=torch.int32,
                          device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(8))
    e, _ = hold_resolve(
        f"the same with its {int(unwritten.sum())} unwritten slots random",
        (torch.where(unwritten, noise[0], got[0]),
         torch.where(unwritten, noise[1], got[1]), *r_args[2:]), card, corpus)
    rerr = max(rerr, e)
    Tc = int(count.max())
    toks, starts = got[0][:Tc].contiguous(), got[1][:Tc].contiguous()
    e, _ = hold_resolve(f"the same trimmed to its {Tc} occupied rows",
                        (toks, starts, *r_args[2:]), card, corpus)
    rerr = max(rerr, e)
    raw = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).cuda()
    k0 = int(np.searchsorted(f_index.anchor_out, 40000))
    cut = int(f_index.anchor_out[k0])
    e, _ = hold_resolve(
        f"the group from lane {k0} behind a 32 KiB prefix",
        (toks[:, k0:].contiguous(), starts[:, k0:].contiguous(),
         count[k0:].contiguous(), (p.out_base[k0:] - cut + 32768).contiguous(),
         32768 + len(corpus) - cut, raw[cut - 32768 : cut]), card,
        corpus[cut - 32768 :])
    rerr = max(rerr, e)
    for P, below in ((32768, False), (0, True)):
        args = random_generic_tokens(4097, 8, P, seed=P + 7, below=below)
        args = tuple(torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                     else a for a in args)
        e, flagged = hold_resolve(f"4097 random lanes, prefix {P}", args,
                                  card)
        assert flagged == below
        rerr = max(rerr, e)
    start.record()
    ik.resolve_global_plain(*r_args)
    end.record()
    torch.cuda.synchronize()
    records["resolve_global"] = dict(
        replaces="zlibes_tpu/ops/inflate_kernel.py:152",
        note="the reference's resolve_global is an XLA scatter / cummax / "
             "pointer-doubling program, not a pallas_call; the kernel is "
             "an expand launch and one launch a round, counted as one",
        max_abs_err=rerr, ms=cuda_ms(lambda: ik.resolve_global(*r_args)),
        plain_ms=start.elapsed_time(end), plain_runs=1,
        shape=[p.d_total], tokens_shape=list(got[0].shape),
        # read: the emitted tokens and starts, the per-lane arrays;
        # written: the bytes; ~10 operations a byte and 20 a token (the
        # expansion, the copy)
        **bound(nbytes(count, p.out_base) + 2 * 4 * n_tok + p.d_total,
                10 * p.d_total + 20 * n_tok))

    # -- the scan's single lane: kernel and plain on a 50 KB stream
    small = zlib.compress(corpus[:50000], 6)
    s_index = zlibes_tpu_torch.build_index(small)
    s_stream = ip._Stream(small, "cuda")
    blk = s_index.blocks[0]
    lt, dt = ip._tables("cuda", [ip._block_code_lengths(small, blk)])
    one = dict(device="cuda")
    s_lanes = (s_stream.words, lt, dt,
               torch.zeros(1, dtype=torch.int32, **one),
               torch.tensor([blk.payload_start_bit], **one),
               torch.tensor([s_stream.total_bits], **one),
               torch.ones(1, dtype=torch.bool, **one))
    s_got = ik.decode_tokens(*s_lanes, T=ip._SCAN_CHUNK_TOKENS)
    torch.cuda.synchronize()
    s_want = ik.decode_tokens_plain(*s_lanes, ip._SCAN_CHUNK_TOKENS)
    records["decode_tokens"]["max_abs_err"] = max(
        records["decode_tokens"]["max_abs_err"],
        hold_tokens(f"the scan's lane of block 0 of a {len(small)} B stream",
                    s_got, s_want, ip._SCAN_CHUNK_TOKENS, card))
    assert int(s_got[3][0]) == blk.end_bit
    hold_walk_and_span_cases(records, card)

    # -- end to end through the public entry points, launches counted
    tk.LAUNCHES.clear()
    spans = zlibes_tpu_torch.inflate_to_device(flush, f_index, device="cuda")
    launches = dict(tk.LAUNCHES)
    (dev_out, off, n), = spans
    assert dev_out.is_cuda and (off, n) == (0, len(corpus))
    assert dev_out.cpu().numpy().tobytes() == corpus
    assert launches == {"decode_tables": 1, "decode_tokens": 1,
                        "resolve_global": 1}, launches
    edge = 5 * 32768
    seek = zlibes_tpu_torch.inflate_range(flush, f_index, edge - 150, 300,
                                          device="cuda")
    assert seek == corpus[edge - 150 : edge + 150]
    print(f"generic inflate_to_device(device='cuda'): one CUDA span of {n} "
          f"B byte-exact, launches {launches}; inflate_range of 300 B "
          f"across the block boundary at {edge} byte-exact")
    # the chained index of the stock-zlib stream: its groups in stream
    # order, each behind the one before (the plan's lanes cut to force
    # several groups of the corpus as well)
    for lanes in (ip._LANES, 256):
        real_lanes, ip._LANES = ip._LANES, lanes
        try:
            c_stats = zlibes_tpu_torch.CodecStats()
            tk.LAUNCHES.clear()
            (c_out, off, n), = zlibes_tpu_torch.inflate_to_device(
                chained, c_index, device="cuda", stats=c_stats)
            c_launches = dict(tk.LAUNCHES)
        finally:
            ip._LANES = real_lanes
        assert c_out.is_cuda and (off, n) == (0, len(corpus))
        assert c_out.cpu().numpy().tobytes() == corpus
        groups = c_stats.dispatches
        assert c_launches == {"decode_tables": 1, "decode_tokens": groups,
                              "resolve_global": groups}, c_launches
        assert c_stats.chained_groups == groups - 1
        print(f"generic inflate_to_device of the chained index ({lanes} "
              f"lanes a group at most): {groups} group(s), "
              f"{c_stats.chained_groups} behind the one before, byte-exact, "
              f"launches {c_launches}")
    rnd = np.random.default_rng(0).integers(0, 256, 40000, np.uint8)
    mixed = corpus[:40000] + rnd.tobytes() + corpus[40000:80000]
    m_comp = zlib_flushed(mixed, 16384)
    m_index = zlibes_tpu_torch.build_index(m_comp)
    stored = [b for b in m_index.blocks if b.btype == 0 and b.out_len]
    assert [(b.out_start, b.out_len) for b in stored] == [(49152, 16384)]
    (m_out, _, _), = zlibes_tpu_torch.inflate_to_device(m_comp, m_index,
                                                        device="cuda")
    assert m_out.cpu().numpy().tobytes() == mixed
    assert zlibes_tpu_torch.inflate_range(m_comp, m_index, 50000, 300,
                                          device="cuda") == mixed[50000:50300]
    print("generic stored block between dynamic blocks (output 49,152-"
          "65,536, one group spanning it): inflate_to_device and a 300 B "
          "inflate_range inside it byte-exact")
    for name, comp, idx in (("32 KiB flushes", flush, f_index),
                            ("no flush, chained", chained, c_index)):
        tk.LAUNCHES.clear()
        out = ip.inflate_raw_indexed(comp, idx, "cuda")
        assert out.cpu().numpy().tobytes() == corpus, name
        print(f"generic inflate_raw_indexed ({name}, "
              f"{len(ip.plan_groups(comp, idx, 'cpu'))} group(s)): "
              f"byte-exact, launches {dict(tk.LAUNCHES)}")
    tk.LAUNCHES.clear()
    out, blocks, end_bit = ip.inflate_raw_scan(chained, 2, device="cuda")
    assert out.cpu().numpy().tobytes() == corpus
    assert end_bit == c_index.blocks[-1].end_bit
    scan_launches = dict(tk.LAUNCHES)
    assert scan_launches["resolve_global"] == 1
    assert scan_launches["decode_tokens"] >= len(c_index.blocks)
    print(f"generic inflate_raw_scan(device='cuda') of the chained stream "
          f"({len(blocks)} blocks): byte-exact, launches {scan_launches}")
    tk.LAUNCHES.clear()
    assert zlibes_tpu_torch.inflate(chained, index=c_index,
                                    device="cuda") == corpus
    assert not tk.LAUNCHES, dict(tk.LAUNCHES)
    print("generic inflate(index=) with the native runtime: the host "
          "decode, byte-exact, no launch")
    real_available = native.available
    native.available = lambda: False
    try:
        for name, idx in (("the 32 KiB-flush index", f_index),
                          ("no index", None)):
            tk.LAUNCHES.clear()
            assert zlibes_tpu_torch.inflate(flush, index=idx,
                                            device="cuda") == corpus
            print(f"generic inflate() without the native runtime, {name}: "
                  f"byte-exact, Adler-32 on the device, launches "
                  f"{dict(tk.LAUNCHES)}")
        # -- corruption probe through the device path
        rng = np.random.default_rng(6)
        raised = 0
        for _ in range(6):
            bad = bytearray(flush)
            pos = int(rng.integers(16, len(bad) - 8))
            bad[pos] ^= int(rng.integers(1, 256))
            try:
                got_bad = zlibes_tpu_torch.inflate(bytes(bad), index=f_index,
                                                   device="cuda")
            except (CorruptError, ChecksumError) as exc:
                raised += 1
                print(f"generic corruption at byte {pos}: "
                      f"{type(exc).__name__}")
            else:
                assert got_bad == corpus, f"flip at {pos} gave wrong bytes"
                print(f"generic corruption at byte {pos}: in a bit gap")
        assert raised >= 4, f"only {raised} of 6 corruptions detected"
        device_call_s = wall_s(lambda: zlibes_tpu_torch.inflate(
            flush, index=f_index, device="cuda"))
        scan_call_s = wall_s(lambda: zlibes_tpu_torch.inflate(
            chained, device="cuda"), runs=3)
    finally:
        native.available = real_available

    # -- times
    trailer = int.from_bytes(flush[-4:], "big")

    def device_pipeline():
        out = ip.run_group(stream, p, check=False)
        return adler32_device(out)

    assert int(device_pipeline()) == trailer
    pipe_ms = cuda_ms(device_pipeline)

    def to_device():
        out = zlibes_tpu_torch.inflate_to_device(flush, f_index,
                                                 device="cuda")
        torch.cuda.synchronize()
        return out

    n = len(corpus)
    to_device_s = wall_s(to_device)
    plan_s = wall_s(lambda: ip.plan_groups(flush, f_index, "cuda"))
    seek_s = wall_s(lambda: zlibes_tpu_torch.inflate_range(
        flush, f_index, edge - 150, 300, device="cuda"))
    native_s = wall_s(lambda: zlibes_tpu_torch.inflate(flush, index=f_index,
                                                       device="cuda"))
    zlib_f_s = wall_s(lambda: zlib.decompress(flush))
    zlib_c_s = wall_s(lambda: zlib.decompress(chained))
    print(f"generic host: plan_groups ({p.B} lanes, {p.lt.shape[0]} table "
          f"rows, copies to the card) {plan_s * 1e3:.2f} ms, median of 5 "
          f"{card}")
    print(f"generic device pipeline (plan prebuilt, stream on device; "
          f"decode + resolve + adler32): {pipe_ms:.4f} ms -> "
          f"{n / pipe_ms / 1e6:.3f} GB/s of output, median of 20 {card}")
    print(f"generic whole inflate_to_device() call, host to device: "
          f"{to_device_s * 1e3:.2f} ms -> {n / to_device_s / 1e9:.4f} GB/s; "
          f"inflate() without the native runtime, host to host: "
          f"{device_call_s * 1e3:.2f} ms; inflate_range seek (300 B across a "
          f"block boundary): {seek_s * 1e3:.2f} ms; inflate() through the "
          f"native runtime: {native_s * 1e3:.2f} ms; medians of 5 {card}")
    print(f"generic un-indexed inflate() of the chained stream without the "
          f"native runtime (the scan: {len(blocks)} single-lane decodes + "
          f"one resolve): {scan_call_s * 1e3:.2f} ms, median of 3 {card}")
    print(f"CPython zlib.decompress, one core: flushed stream "
          f"{zlib_f_s * 1e3:.2f} ms, chained {zlib_c_s * 1e3:.2f} ms, "
          f"medians of 5 (host CPU beside {card})")
    device_ms = profile_pipeline(device_pipeline, card)
    if device_ms:
        busy = device_ms.busy
        print(f"generic untraced device pipeline: device busy {busy:.4f} of "
              f"{pipe_ms:.4f} ms -> idle share {1 - busy / pipe_ms:.3f} "
              f"{card}")
    call_ms = profile_pipeline(to_device, card, runs=3)
    if call_ms:
        busy = call_ms.busy
        print(f"generic inflate_to_device(): device busy {busy:.4f} of "
              f"{to_device_s * 1e3:.2f} ms per untraced call -> idle share "
              f"{1 - busy / (to_device_s * 1e3):.3f} {card}")
    r = records["decode_tokens"]
    r["device_ms"] = device_time(device_ms, "decode_tokens")
    flatten_ms = device_time(device_ms, "decode_tokens_flatten")
    lane_report("decode_tokens", r, got[0], count, ik.TOK_MATCH_BIT,
                r["device_ms"], card)
    print(f"decode_tokens: the flatten launch {flatten_ms:.4f} ms of it "
          f"({p.lt.shape[0]} rows into {p.lt.shape[0] * ik.FLAT_W * 4} B of "
          f"one-level roots), the walk {r['device_ms'] - flatten_ms:.4f} "
          f"{card}")
    rr = records["resolve_global"]
    rr["device_ms"] = device_time(device_ms, "resolve_global")
    expand_ms = device_time(device_ms, "resolve_global_expand")
    _, _, open_ = ik._resolve_global_cuda(*r_args)
    flags = open_.tolist()
    rr.update(rounds=len(flags) - 1, rounds_with_work=sum(flags[:-1]),
              expand_ms=expand_ms, rounds_ms=rr["device_ms"] - expand_ms)
    assert flags[-1] == 0, flags
    print(f"resolve_global: expand {expand_ms:.4f} ms, rounds "
          f"{rr['rounds_ms']:.4f} ms ({rr['rounds_with_work']} of its "
          f"{rr['rounds']} rounds found a byte open; flags {flags}) on "
          f"{p.d_total} B in {-(-p.d_total // ik.RESOLVE_TILE)} tiles {card}")
    for name in ("decode_tokens", "resolve_global"):
        r = records[name]
        print(f"kernel {name}: exact vs plain (max_abs_err "
              f"{r['max_abs_err']}), kernel {r['ms']:.4f} ms by events "
              f"(median of 20), device {r['device_ms']:.4f} ms a launch "
              f"(torch.profiler), bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['bytes']} B), share of the bound "
              f"{r['bound_ms'] / r['device_ms']:.3f}, plain "
              f"{r['plain_ms']:.1f} ms (one run), shape {r['shape']}"
              + (f", tokens {r['tokens_shape']}" if "tokens_shape" in r
                 else "") + f", library call: none {card}")
    scan_s = wall_s(lambda: ip.inflate_raw_scan(chained, 2, device="cuda"),
                    runs=3)
    scan_ms = profile_pipeline(
        lambda: ip.inflate_raw_scan(chained, 2, device="cuda"), card, runs=2,
        quiet=True)
    if scan_ms:
        busy = scan_ms.busy
        n_dec = scan_launches["decode_tokens"]
        dec = device_time(scan_ms, "decode_tokens")
        res = device_time(scan_ms, "resolve_global")
        print(f"generic scan (inflate_raw_scan of the chained stream, "
              f"{len(blocks)} blocks): whole call {scan_s * 1e3:.2f} ms "
              f"(median of 3), device busy {busy:.4f} ms a call, of it "
              f"decode_tokens {dec * n_dec:.4f} ms ({n_dec} launches, "
              f"{dec:.4f} a launch; share of busy {dec * n_dec / busy:.3f}),"
              f" resolve_global {res:.4f} ms {card}")
    return launches, device_ms


# ---------------------------------------------------------------------------
# the shared-table encoder outside the turbo profile

def nci_like(size: int = 33_553_445, seed: int = 0) -> bytes:
    """``size`` bytes (Silesia's nci, the bench's largest read file) of
    seeded 64-256 KiB slices of ``raw.bin`` read as a ring, in a seeded
    order: the benchmark corpus's recipe (``benchmark/harness/corpus.py``),
    not its seed."""
    raw = np.frombuffer((GOLDEN / "raw.bin").read_bytes(), np.uint8)
    g = np.random.default_rng(seed)
    ring = np.concatenate([raw, raw[:256 * 1024]])
    parts, have, off = [], 0, int(g.integers(0, raw.size))
    while have < size:
        n = min(int(g.integers(64 * 1024, 256 * 1024 + 1)), size - have)
        parts.append(ring[off:off + n])
        off = (off + n) % raw.size
        have += n
    return np.concatenate([parts[k] for k in
                           g.permutation(len(parts))]).tobytes()


def decode_tables_phase(card: str, records: dict) -> None:
    """``decode_tables`` at the shapes of the bench's largest read file
    (an nci-sized file): the stock-zlib plan (CPython level 6,
    ``build_index``: one row a block that has anchors) and the wide plan
    (the port's level-6 encode and wide index: one row a coded block).
    Each launch exact against its plain version (the host parse and
    ``wide_decode_tables``), its device time (torch.profiler) and CUDA
    event time, the plain version's host time, the bound; then
    ``inflate_to_device`` of both streams through one launch, every coded
    block in ``CodecStats.device_headers``."""
    import zlibes_tpu_torch
    from zlibes_tpu_torch.codec import deflate_pipeline as dp
    from zlibes_tpu_torch.ops import decode_tables as dtab
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops.inflate_kernel import stream_words

    data = nci_like()
    t0 = time.perf_counter()
    stock = zlib.compress(data, 6)
    s_index = zlibes_tpu_torch.build_index(stock)
    wide, w_index = dp.deflate(data, with_index=True, level=6, device="cuda")
    print(f"decode_tables inputs: {len(data)} B nci-sized file, stock zlib "
          f"{len(stock)} B ({len(s_index.blocks)} blocks), the port's level "
          f"6 {len(wide)} B ({len(w_index.blocks)} blocks), made in "
          f"{time.perf_counter() - t0:.1f} s")
    rec = None
    for what, comp, index in (("stock-zlib plan", stock, s_index),
                              ("wide plan", wide, w_index)):
        if index.wide:
            blocks = [b for b in index.blocks if b.out_len and b.btype != 0]
        else:
            blocks = [index.blocks[int(b)]
                      for b in np.unique(index.anchor_block)]
        words = torch.from_numpy(stream_words(comp)).cuda()
        hdr = torch.from_numpy(dtab.headers(blocks)).cuda()
        nbits = len(comp) * 8
        got = dtab.decode_tables(words, hdr, nbits)
        torch.cuda.synchronize()
        p_args = (words.cpu(), hdr.cpu(), nbits)
        want = dtab.decode_tables_plain(*p_args)
        assert not want[2].any(), f"{what}: a bad header"
        for g, w, name in zip(got, want, ("lt", "dt", "status")):
            assert torch.equal(g.cpu(), w), f"decode_tables {what}: {name}"
        ev_ms = cuda_ms(lambda: dtab.decode_tables(words, hdr, nbits))
        dev_ms, n_rec = kernel_event_ms(
            lambda: dtab.decode_tables(words, hdr, nbits), "decode_tables")
        plain_ms = wall_s(lambda: dtab.decode_tables_plain(*p_args),
                          runs=3) * 1e3
        hdr_bytes = sum((b.payload_start_bit - b.start_bit + 7) // 8
                        for b in blocks if b.btype != 1)
        r = dict(
            replaces="none: the JAX package parses each block's header and "
                     "builds its decode tables on the host",
            source="zlibes_tpu_torch/csrc/decode_tables.cu",
            note="no Pallas counterpart; plain_ms is the host parse and "
                 "wide_decode_tables on the host clock (median of 3), not "
                 "a device time; the kernel is latency-bound (a header's "
                 "code-length symbols one after another), the bound counts "
                 "bytes alone",
            max_abs_err=max(max_abs_err(g.cpu(), w)
                            for g, w in zip(got, want)),
            ms=ev_ms, device_ms=dev_ms, plain_ms=plain_ms, plain_runs=3,
            shape=[len(blocks), 3],
            # read: the per-block input and each header's bytes; written:
            # both rows and the status of every block
            **bound(nbytes(hdr, *got) + hdr_bytes, 0))
        print(f"kernel decode_tables, {what} ({len(blocks)} rows): exact vs "
              f"plain; device {dev_ms:.4f} ms a launch (torch.profiler, "
              f"{n_rec} records), events {ev_ms:.4f} ms (median of 20), "
              f"bound {r['bound_ms']:.5f} ms ({r['bytes']} B), plain "
              f"{plain_ms:.2f} ms (host clock, median of 3) {card}")
        if rec is None:
            rec = r
        else:
            rec["wide plan"] = r
        stats = zlibes_tpu_torch.CodecStats()
        tk.LAUNCHES.clear()
        t0 = time.perf_counter()
        (out, _, n), = zlibes_tpu_torch.inflate_to_device(
            comp, index, device="cuda", stats=stats)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        assert out.cpu().numpy().tobytes() == data, what
        assert dict(tk.LAUNCHES)["decode_tables"] == 1, dict(tk.LAUNCHES)
        assert stats.device_headers == len(blocks), (stats.device_headers,
                                                     len(blocks))
        print(f"inflate_to_device, {what}: byte-exact, launches "
              f"{dict(tk.LAUNCHES)}, device_headers {stats.device_headers}, "
              f"{call_ms:.1f} ms the call (host clock, one run) {card}")
    records["decode_tables"] = rec


def shared_dispatch(data: bytes, cfg):
    """The first dispatch of ``data`` under the shared-tables config
    ``cfg`` on the card, as the pipeline makes it: block rows, valid
    counts and the matches."""
    from zlibes_tpu_torch.codec.framing import stage_rows
    from zlibes_tpu_torch.ops.lz77 import find_matches

    N, Bp = cfg.block_size, cfg.blocks_per_dispatch
    arr = np.frombuffer(data, np.uint8)
    blk_np, nv_np = stage_rows(arr, 0, min(Bp, -(-arr.size // N)), N, Bp)
    blk = torch.from_numpy(blk_np).cuda()
    nv = torch.from_numpy(nv_np).cuda()
    return blk, nv, find_matches(blk, nv, N=N, S=cfg.probe_words,
                                 J=cfg.candidates, reset=cfg.chunk_reset,
                                 two_phase=cfg.max_code_bits <= 9)


def random_far_matches(B: int, N: int, max_dist: int, seed: int):
    """(B, N + 8) random bytes, (B, N) random packed matches of 0-258 bytes
    to ``max_dist`` back (40% none), a fifth of them long (131-258) and
    farther than 2048 where ``max_dist`` allows, and (B,) valid counts."""
    g = torch.Generator().manual_seed(seed)
    data = torch.randint(0, 256, (B, N + 8), generator=g, dtype=torch.uint8)
    ml = torch.randint(0, 259, (B, N), generator=g)
    ml = torch.where(torch.rand((B, N), generator=g) < 0.4, 0, ml)
    dist = torch.randint(1, max_dist + 1, (B, N), generator=g)
    far = torch.rand((B, N), generator=g) < 0.2
    ml = torch.where(far, torch.randint(131, 259, (B, N), generator=g), ml)
    dist = torch.where(far, torch.randint(2049, max_dist + 1, (B, N),
                                          generator=g), dist)
    nv = torch.full((B,), N, dtype=torch.int32)
    nv[-1] = N // 3
    return data, ((ml << 16) | dist).int(), nv


def hold_shared_kernels(corpus: bytes, configs: dict, records: dict,
                        card: str) -> None:
    """The kernel variants the shared-table configs launch, against their
    plain versions with max_abs_err 0, at the corpus' first dispatch of
    each config (the main path's shapes) and on random matches with far
    long ones: ``select_turbo`` with ``split_far`` off (``shared_turbo15``),
    ``select_tokens`` with ``split_far`` on and 1,024-byte lanes
    (``shared_seg1024``) and on 512-byte lanes (``shared_full``), and
    ``encode_fields`` on fields over 32 bits (``shared_full`` on the skewed
    buffer).  Adds each variant's numbers to its kernel's record."""
    from shared_tables_cases import skewed_data

    from zlibes_tpu_torch.codec import deflate_pipeline as dp
    from zlibes_tpu_torch.codec.inflate_pipeline import _block_code_lengths
    from zlibes_tpu_torch.ops import deflate_kernel as dk
    from zlibes_tpu_torch.ops import encode_kernel as ek
    from zlibes_tpu_torch.ops import lz77
    from zlibes_tpu_torch.ops import turbo_kernel as tk

    # -- select_turbo, split_far off
    cfg = configs["shared_turbo15"]
    N = cfg.block_size
    blk, nv, matches = shared_dispatch(corpus, cfg)
    pv, slen = dp.select_inputs(blk, matches, nv, N)
    toks, cnt = tk.select_turbo(pv, slen, split_far=False)
    torch.cuda.synchronize()
    toks_p, cnt_p = tk.select_turbo_plain(pv, slen, True, False)
    assert torch.equal(toks, toks_p) and torch.equal(cnt, cnt_p), \
        "select_turbo(split_far=False) != plain on the shared_turbo15 dispatch"
    err = max(max_abs_err(cnt, cnt_p), max_abs_err(toks, toks_p))
    data_r, m_r, nv_r = random_far_matches(2, N, 4095, 21)
    pv_r, slen_r = dp.select_inputs(data_r.cuda(), m_r.cuda(), nv_r.cuda(),
                                    N)
    for lazy in (True, False):
        got = tk.select_turbo(pv_r, slen_r, lazy=lazy, split_far=False)
        torch.cuda.synchronize()
        want = tk.select_turbo_plain(pv_r, slen_r, lazy, False)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"select_turbo(split_far=False) != plain on random ({lazy=})"
        err = max([err] + [max_abs_err(a, b) for a, b in zip(got, want)])
        t = got[0]
        ml = t & tk.TOK_VAL_MASK
        far = (t & tk.TOK_MATCH_BIT) != 0
        far &= ((t >> tk.TOK_DIST_SHIFT) & tk.TOK_DIST_MASK) > 2048
        assert bool((far & (ml > 130)).any()), "no far long match kept whole"
    n_tok = int(cnt.sum())
    records["select_turbo"]["split_far off"] = dict(
        config="shared_turbo15", max_abs_err=err,
        ms=cuda_ms(lambda: tk.select_turbo(pv, slen, split_far=False)),
        plain_ms=cuda_ms(lambda: tk.select_turbo_plain(pv, slen, True,
                                                       False),
                         runs=3, warmup=1),
        shape=list(toks.shape), tokens=n_tok,
        **bound(nbytes(pv, slen, toks, cnt),
                25 * pv.numel() + 4 * n_tok))
    records["select_turbo"]["max_abs_err"] = max(
        records["select_turbo"]["max_abs_err"], err)

    # -- select_tokens, split_far on (1,024-byte lanes) and off (512)
    for name, what in (("shared_seg1024", "split_far on, seg 1024"),
                       ("shared_full", "split_far off, seg 512")):
        cfg = configs[name]
        N, SEG = cfg.block_size, cfg.seg_size
        split_far = cfg.max_code_bits <= 9
        kw = dict(N=N, SEG_SIZE=SEG, lazy=cfg.lazy, split_far=split_far)
        blk, nv, matches = shared_dispatch(corpus, cfg)
        err, (tv, td, cnt), plain_ms = hold_select_tokens(
            (blk, matches, nv), kw, f"the {name} dispatch", card)
        data_r, m_r, nv_r = random_far_matches(2, N, 32768, 22)
        for lazy in (True, False):
            e, (rtv, rtd, _), _ = hold_select_tokens(
                (data_r.cuda(), m_r.cuda(), nv_r.cuda()),
                dict(kw, lazy=lazy), f"random far matches, SEG {SEG}, "
                f"split_far={split_far}, lazy={lazy}", card)
            err = max(err, e)
            capped = bool(((rtv == 130) & (rtd > 2048)).any())
            kept = bool(((rtv > 130) & (rtd > 2048)).any())
            assert kept != split_far and (capped or not split_far), \
                (name, capped, kept)
        n_tok = int(cnt.sum())
        records["select_tokens"][what] = dict(
            config=name, max_abs_err=err,
            ms=cuda_ms(lambda: lz77.select_tokens(blk, matches, nv, **kw)),
            plain_ms=plain_ms, plain_runs=1, shape=list(tv.shape),
            tokens=n_tok,
            **bound(nbytes(matches, nv, tv, td, cnt) + matches.numel(),
                    20 * matches.numel() + 4 * n_tok))
        records["select_tokens"]["max_abs_err"] = max(
            records["select_tokens"]["max_abs_err"], err)

    # -- encode_fields on fields over 32 bits: shared_full's tables and
    # tokens on the skewed buffer, and at the corpus' first dispatch
    cfg = configs["shared_full"]
    N, SEG = cfg.block_size, cfg.seg_size
    err = 0
    wide_fields = {}
    for what, data in (("the skewed buffer", skewed_data()),
                       ("the corpus", corpus)):
        comp, index = dp.deflate(data, with_index=True, config=cfg,
                                 device="cuda")
        ll, dl = _block_code_lengths(comp, index.blocks[0])
        ll_code, d_code = dp._encode_tables(ll, dl)
        lt, dt = (t.cuda() for t in ek.pack_tables(ll_code, ll, d_code, dl))
        blk, nv, matches = shared_dispatch(data, cfg)
        tv, td, cnt = lz77.select_tokens(blk, matches, nv, N=N, SEG_SIZE=SEG,
                                         lazy=cfg.lazy)
        _, _, valid, _, _ = dk.token_symbols(tv, td, cnt, nseg=N // SEG)
        f_args = (tv.reshape(-1), td.reshape(-1), valid.int().reshape(-1),
                  lt, dt)
        val, nb = ek.encode_fields(*f_args)
        torch.cuda.synchronize()
        val_p, nb_p = ek.encode_fields_plain(*f_args)
        assert torch.equal(val, val_p) and torch.equal(nb, nb_p), \
            f"encode_fields != plain on {what}"
        err = max(err, max_abs_err(val, val_p), max_abs_err(nb, nb_p))
        wide = int((nb > 32).sum())
        print(f"kernel encode_fields on shared_full's tables and tokens of "
              f"{what}: exact vs plain, {wide} fields over 32 bits (widest "
              f"{int(nb.max())}) of {int(valid.sum())} {card}")
        if what == "the skewed buffer":
            assert wide > 0, "no field over 32 bits on the skewed buffer"
        wide_fields[what] = wide
    records["encode_fields"]["fields over 32 bits"] = dict(
        config="shared_full", max_abs_err=err, wide_fields=wide_fields,
        ms=cuda_ms(lambda: ek.encode_fields(*f_args)),
        plain_ms=cuda_ms(lambda: ek.encode_fields_plain(*f_args), runs=10),
        shape=list(val.shape),
        # read: three int32 a token and the tables; written: the int64
        # field and the int32 count; ~60 operations a token
        **bound(nbytes(*f_args, val, nb), 60 * val.numel()))
    records["encode_fields"]["max_abs_err"] = max(
        records["encode_fields"]["max_abs_err"], err)
    for name in ("select_turbo", "select_tokens", "encode_fields"):
        for what, r in records[name].items():
            if isinstance(r, dict) and "config" in r:
                print(f"kernel {name} ({what}, {r['config']}): exact vs plain "
                      f"(max_abs_err {r['max_abs_err']}), kernel "
                      f"{r['ms']:.4f} ms (median of 20), plain "
                      f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                      f"by {r['bound_by']}, shape {r['shape']} {card}")


def shared_round_trips(comp: bytes, index, data: bytes, what: str) -> dict:
    """``comp`` and its index back to ``data`` through CPython,
    ``inflate(index=)``, ``inflate()`` without an index, a seek across the
    first block boundary (or the middle) and ``inflate_to_device``, all on
    the card; returns the launch counts of the ``inflate_to_device``
    call."""
    import zlibes_tpu_torch
    from zlibes_tpu_torch.ops import turbo_kernel as tk

    assert zlib.decompress(comp) == data, f"CPython refuses {what}"
    assert zlibes_tpu_torch.inflate(comp, index=index, device="cuda") == data
    assert zlibes_tpu_torch.inflate(comp, device="cuda") == data
    edge = index.blocks[0].out_len if len(index.blocks) > 2 else len(data) // 2
    lo = max(0, edge - 2500)
    assert zlibes_tpu_torch.inflate_range(comp, index, lo, 5000,
                                          device="cuda") == data[lo:lo + 5000]
    tk.LAUNCHES.clear()
    spans = zlibes_tpu_torch.inflate_to_device(comp, index, device="cuda")
    launches = dict(tk.LAUNCHES)
    out = bytearray(len(data))
    for t, off, n in spans:
        assert t.is_cuda
        out[off:off + n] = t[:n].cpu().numpy().tobytes()
    assert bytes(out) == data, f"inflate_to_device({what}) != the input"
    assert launches.get("decode_tokens", 0) >= 1 and \
        launches.get("resolve_global", 0) >= 1, launches
    return launches


def shared_phase(corpus: bytes, card: str, records: dict) -> dict:
    """The shared-table encoder outside the turbo profile, for the three
    configs of ``tests/shared_tables_cases.py``: ``deflate(corpus,
    config=...)`` on the card with the launch counts set to 0 just before
    and read just after, the stream and its index held against
    ``tests/golden/shared_bench.json``, the round trips (CPython,
    ``inflate(index=)``, ``inflate()``, ``inflate_range``,
    ``inflate_to_device``, whose group decode launches ``decode_tokens`` and
    ``resolve_global``); the same on the two buffers that take coded tokens
    past 32 bits; whole-call times and each kernel's device ms a launch.
    Then the kernel variants against their plain versions
    (``hold_shared_kernels``).  Returns {config: launch counts of its
    ``deflate`` run}."""
    from shared_tables_cases import SHARED_CONFIGS, far_copy_data, skewed_data
    from torch_parallel_worker import index_sha256

    import zlibes_tpu_torch
    from zlibes_tpu_torch.codec import deflate_pipeline as dp
    from zlibes_tpu_torch.ops import turbo_kernel as tk

    gold = json.loads((GOLDEN / "shared_bench.json").read_text())
    buffers = {"skewed": skewed_data(), "far_copies": far_copy_data()}
    select = {"shared_full": "select_tokens",
              "shared_turbo15": "select_turbo",
              "shared_seg1024": "select_tokens"}
    out_launches = {}
    for name, cfg in SHARED_CONFIGS.items():
        want = gold[name]
        fields = {f: getattr(cfg, f) for f in want["config"]}
        assert fields == want["config"], (name, fields)
        nblocks = -(-len(corpus) // cfg.block_size)
        dispatches = -(-nblocks // cfg.blocks_per_dispatch)
        tk.LAUNCHES.clear()
        out = zlibes_tpu_torch.deflate(corpus, config=cfg, device="cuda")
        launches = dict(tk.LAUNCHES)
        g = want["corpus"]
        assert (len(out), hashlib.sha256(out).hexdigest()) == \
            (g["length"], g["sha256"]), f"{name}: != shared_bench.json"
        # phase 1 keeps its tokens (the corpus is within
        # phase1_cache_blocks): one select and one encode_fields a dispatch
        assert nblocks <= cfg.phase1_cache_blocks
        assert launches == {select[name]: dispatches,
                            "encode_fields": dispatches}, (name, launches)
        comp, index = dp.deflate(corpus, with_index=True, config=cfg,
                                 device="cuda")
        assert comp == out and not index.turbo and not index.wide
        assert index_sha256(index) == g["index"]["sha256"], name
        assert index.max_tokens == g["index"]["max_tokens"], name
        to_dev = shared_round_trips(out, index, corpus, f"{name} corpus")
        print(f"shared {name}: deflate(corpus, config=..., device='cuda') "
              f"{len(out)} B (ratio {len(out) / len(corpus):.4f}), stream and "
              f"index equal shared_bench.json (digests from {g['source']}, "
              f"widest token {g['widest_token_bits']} bits); launches a call "
              f"{launches} ({dispatches} dispatches); CPython, "
              f"inflate(index=), inflate(), inflate_range and "
              f"inflate_to_device ({to_dev}) return the corpus")
        for what, data in buffers.items():
            b = want[what]
            comp, idx = dp.deflate(data, with_index=True, config=cfg,
                                   device="cuda")
            assert (len(comp), hashlib.sha256(comp).hexdigest(),
                    index_sha256(idx)) == (b["length"], b["sha256"],
                                           b["index"]["sha256"]), \
                f"{name} {what}: != shared_bench.json"
            shared_round_trips(comp, idx, data, f"{name} {what}")
            print(f"shared {name} on {what} ({len(data)} B): {len(comp)} B "
                  f"equal to shared_bench.json (digests from {b['source']}, "
                  f"widest token {b['widest_token_bits']} bits), round trips "
                  f"byte-exact")
        call_s = wall_s(lambda: zlibes_tpu_torch.deflate(
            corpus, config=cfg, device="cuda"), runs=3)
        dev_s = wall_s(lambda: zlibes_tpu_torch.inflate_to_device(
            out, index, device="cuda"), runs=3)
        trace = profile_pipeline(lambda: zlibes_tpu_torch.deflate(
            corpus, config=cfg, device="cuda"), card, runs=1, quiet=True)
        kms = {k: device_time(trace, k) for k in launches}
        busy = trace.busy
        print(f"shared {name}: whole deflate() call {call_s * 1e3:.2f} ms -> "
              f"{len(corpus) / call_s / 1e9:.4f} GB/s of input (median of "
              f"3), device busy {busy:.4f} ms a call (idle share "
              f"{1 - busy / (call_s * 1e3):.3f}); device ms a launch "
              + ", ".join(f"{k} {v:.4f}" for k, v in kms.items())
              + f"; inflate_to_device() {dev_s * 1e3:.2f} ms (median of 3) "
              f"{card}")
        for k, v in kms.items():
            records[k].setdefault("shared_device_ms", {})[name] = v
        out_launches[name] = launches
    hold_shared_kernels(corpus, SHARED_CONFIGS, records, card)
    return out_launches


# ---------------------------------------------------------------------------
# block parallelism: zlibes_tpu_torch.parallel over torch.distributed

PARALLEL_RANK_TIMEOUT = 300     # seconds a rank of the world of 2 may take
BATCH_SEED = 11                 # numpy seed of the compress_batch payloads


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def batch_payloads(corpus: bytes) -> tuple[list[bytes], bytes]:
    """256 payloads of 1-4 KiB cut from the corpus at seeded offsets, and a
    32 KiB dictionary from its start: many small RPC bodies against one
    shared dictionary."""
    rng = np.random.default_rng(BATCH_SEED)
    sizes = rng.integers(1024, 4097, 256)
    offs = rng.integers(32768, len(corpus) - 4096, 256)
    return ([corpus[o : o + s] for o, s in zip(offs, sizes)],
            corpus[:32768])


def hold_parallel_kernels(corpus: bytes, records: dict, card: str) -> None:
    """The encode kernels at the shapes the parallel path gives them: the
    first dispatch of 16 blocks of 32 KiB (``select_tokens`` in segments
    of 1,024 for the dynamic and fixed encodes; ``select_turbo`` and
    ``encode_fields`` for the turbo one) and the first 64 rows of the
    dictionary batch (``select_tokens`` behind a 32 KiB prefix), each
    against its plain version.  The decode kernels at world 1 take the
    whole stream's lanes, the shapes the earlier phases hold."""
    from zlibes_tpu_torch.codec import deflate_pipeline as dp
    from zlibes_tpu_torch.codec.framing import stage_rows
    from zlibes_tpu_torch.ops import encode_kernel as ek
    from zlibes_tpu_torch.ops import lz77
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops.deflate_kernel import token_symbols
    from zlibes_tpu_torch.parallel import batch as pb
    from zlibes_tpu_torch.parallel import block_parallel as bp

    N = 32768
    rows_np, nv_np = stage_rows(np.frombuffer(corpus, np.uint8), 0,
                               bp.DISPATCH_BLOCKS, N)
    rows = torch.from_numpy(rows_np).cuda()
    nv = torch.from_numpy(nv_np).cuda()
    matches = lz77.find_matches(rows, nv, N=N, S=bp._S, J=bp._J)
    args, kw = (rows, matches, nv), dict(N=N, SEG_SIZE=1024)
    err, _got, plain_ms = hold_select_tokens(
        args, kw, "the parallel dynamic dispatch (16 x 32 KiB, SEG 1024)",
        card)
    ms = cuda_ms(lambda: lz77.select_tokens(*args, **kw))
    records["select_tokens"]["max_abs_err"] = max(
        records["select_tokens"]["max_abs_err"], err)
    print(f"kernel select_tokens, parallel dispatch: {ms:.4f} ms (median of "
          f"20), plain {plain_ms:.2f} ms (one run) {card}")

    tm = lz77.find_matches(rows, nv, N=N, S=bp._S, J=bp._J, reset=4096,
                           two_phase=True)
    pv, slen = dp.select_inputs(rows, tm, nv, N)
    toks, cnt = tk.select_turbo(pv, slen)
    torch.cuda.synchronize()
    toks_p, cnt_p = tk.select_turbo_plain(pv, slen)
    assert torch.equal(toks, toks_p) and torch.equal(cnt, cnt_p), \
        "select_turbo != plain on the parallel turbo dispatch"
    err = max(max_abs_err(toks, toks_p), max_abs_err(cnt, cnt_p))
    records["select_turbo"]["max_abs_err"] = max(
        records["select_turbo"]["max_abs_err"], err)
    print(f"kernel select_turbo, parallel turbo dispatch {list(pv.shape)}: "
          f"exact vs plain (max_abs_err {err}), "
          f"{cuda_ms(lambda: tk.select_turbo(pv, slen)):.4f} ms (median of "
          f"20) {card}")
    tv, td, cnt = dp.select_glue(rows, tm, nv, N, lazy=True)
    _ls, _ds, valid, llf, dfq = token_symbols(tv, td, cnt, nseg=N // 512)
    from zlibes_tpu_torch.ops.entropy import limited_lengths_pair

    ll_len, d_len = (x.long().cpu().numpy() for x in limited_lengths_pair(
        llf.sum(0), dfq.sum(0), 9))
    ll_code, d_code = dp._encode_tables(ll_len, d_len)
    lt, dt = (t.cuda() for t in ek.pack_tables(ll_code, ll_len, d_code,
                                               d_len))
    fargs = (tv.reshape(-1), td.reshape(-1), valid.int().reshape(-1), lt, dt)
    val, nb = ek.encode_fields(*fargs)
    torch.cuda.synchronize()
    val_p, nb_p = ek.encode_fields_plain(*fargs)
    assert torch.equal(val, val_p) and torch.equal(nb, nb_p), \
        "encode_fields != plain on the parallel turbo dispatch"
    err = max(max_abs_err(val, val_p), max_abs_err(nb, nb_p))
    records["encode_fields"]["max_abs_err"] = max(
        records["encode_fields"]["max_abs_err"], err)
    print(f"kernel encode_fields, parallel turbo dispatch ({val.numel()} "
          f"tokens): exact vs plain (max_abs_err {err}), "
          f"{cuda_ms(lambda: ek.encode_fields(*fargs)):.4f} ms (median of 20)"
          f" {card}")

    payloads, zdict = batch_payloads(corpus)
    P_CAP = 4096
    brows = np.zeros((pb.ROWS_PER_DISPATCH, P_CAP + 8), np.uint8)
    bnv = np.zeros(pb.ROWS_PER_DISPATCH, np.int32)
    for k, p in enumerate(payloads[: pb.ROWS_PER_DISPATCH]):
        brows[k, : len(p)] = np.frombuffer(p, np.uint8)
        bnv[k] = len(p)
    data = torch.cat([torch.from_numpy(np.frombuffer(zdict, np.uint8).copy())
                      [None, :].expand(len(bnv), -1),
                      torch.from_numpy(brows)], 1).cuda()
    nv_full = torch.from_numpy(bnv).cuda() + 32768
    ctx = torch.zeros(len(bnv), dtype=torch.int32, device="cuda")
    bm = lz77.find_matches(data, nv_full, N=32768 + P_CAP, S=8, J=8,
                           ctx_start=ctx)
    err, _got, plain_ms = hold_select_tokens(
        (data, bm, nv_full), dict(N=32768 + P_CAP, SEG_SIZE=1024,
                                  start=32768),
        "the dictionary batch's first 64 rows (behind 32 KiB)", card)
    records["select_tokens"]["max_abs_err"] = max(
        records["select_tokens"]["max_abs_err"], err)


def parallel_streams(corpus: bytes) -> dict:
    """The streams the parallel phase decodes, with their indexes: the
    committed turbo and wide fixtures and the generic phase's CPython
    stream with a full flush every 32 KiB (``build_index``)."""
    import zlibes_tpu_torch
    from test_torch_contract_cases import zlib_flushed
    from zlibes_tpu_torch import StreamIndex

    flush = zlib_flushed(corpus, 32768)
    return dict(
        turbo=((GOLDEN / "turbo_bench.zz").read_bytes(),
               StreamIndex.load(GOLDEN / "turbo_bench.idx.npz")),
        wide=((GOLDEN / "wide_bench.zz").read_bytes(),
              StreamIndex.load(GOLDEN / "wide_bench.idx.npz")),
        generic=(flush, zlibes_tpu_torch.build_index(flush)))


def parallel_calls(corpus: bytes, streams: dict, mesh) -> list:
    """The parallel phase's calls on ``mesh``: (name, call, check, the
    kernels the call must launch)."""
    from torch_parallel_worker import index_sha256
    from zlibes_tpu_torch import parallel as P

    fixture = json.loads((GOLDEN / "parallel_bench.json").read_text())
    ref = fixture["corpus"]
    assert ref["bytes_in"] == len(corpus)
    turbo, t_index = streams["turbo"]
    wide, w_index = streams["wide"]
    flush, g_index = streams["generic"]
    payloads, zdict = batch_payloads(corpus)

    def held(mode):
        def check(res):
            comp, index = res if isinstance(res, tuple) else (res, None)
            want = ref[mode]
            assert len(comp) == want["length"], (mode, len(comp))
            assert hashlib.sha256(comp).hexdigest() == want["sha256"], mode
            assert zlib.decompress(comp) == corpus
            if index is not None:
                assert index_sha256(index) == want["index"]["sha256"]
                assert index.max_tokens == want["index"]["max_tokens"]
        return check

    def back(res):
        assert res == corpus

    def batch_ok(members):
        assert len(members) == len(payloads)
        for m, p in zip(members, payloads):
            assert zlib.decompressobj(zdict=zdict).decompress(m) == p
        assert P.decompress_batch(members, zdict, device="cuda") == payloads

    state = {}

    def turbo_write():
        state["turbo"] = P.parallel_deflate(corpus, mesh, turbo=True,
                                            with_index=True)
        return state["turbo"]

    sel = ("select_tokens",)
    turbo_in = ("decode_turbo", "resolve_turbo")
    return [
        ("parallel_deflate dynamic", lambda: P.parallel_deflate(corpus, mesh),
         held("dynamic"), sel),
        ("parallel_deflate fixed",
         lambda: P.parallel_deflate(corpus, mesh, dynamic=False),
         held("fixed"), sel),
        ("parallel_deflate turbo", turbo_write, held("turbo"),
         ("select_turbo", "encode_fields")),
        ("parallel_inflate turbo_bench",
         lambda: P.parallel_inflate(turbo, t_index, mesh), back, turbo_in),
        ("parallel_inflate wide_bench",
         lambda: P.parallel_inflate(wide, w_index, mesh), back,
         ("wide_lanes", "decode_wide", "resolve_wide")),
        ("parallel_inflate generic (32 KiB flushes)",
         lambda: P.parallel_inflate(flush, g_index, mesh), back,
         ("decode_tokens", "resolve_global")),
        ("parallel_inflate of the turbo stream just written",
         lambda: P.parallel_inflate(*state["turbo"], mesh), back, turbo_in),
        ("compress_batch (256 payloads, 32 KiB dictionary)",
         lambda: P.compress_batch(payloads, zdict, mesh=mesh), batch_ok, sel),
    ]


def single_device_calls(corpus: bytes, streams: dict) -> dict:
    """The single-device call beside each parallel one: the same stream's
    (or, for the shared-table dynamic and fixed encodes, which no
    single-device call writes, level 6's) through the public entry
    points; for the batch, ``compress_batch`` without a process group."""
    import zlibes_tpu_torch
    from zlibes_tpu_torch import CodecConfig
    from zlibes_tpu_torch import parallel as P

    turbo, t_index = streams["turbo"]
    wide, w_index = streams["wide"]
    flush, g_index = streams["generic"]
    payloads, zdict = batch_payloads(corpus)
    level6 = ("deflate(level=6)", lambda: zlibes_tpu_torch.deflate(
        corpus, level=6, device="cuda"))
    return {
        "parallel_deflate dynamic": level6,
        "parallel_deflate fixed": level6,
        "parallel_deflate turbo": ("deflate(config=turbo)",
                                   lambda: zlibes_tpu_torch.deflate(
                                       corpus, config=CodecConfig.turbo(),
                                       device="cuda")),
        "parallel_inflate turbo_bench": (
            "inflate(index=)", lambda: zlibes_tpu_torch.inflate(
                turbo, index=t_index, device="cuda")),
        "parallel_inflate wide_bench": (
            "inflate(index=)", lambda: zlibes_tpu_torch.inflate(
                wide, index=w_index, device="cuda")),
        "parallel_inflate generic (32 KiB flushes)": (
            "inflate_to_device", lambda: zlibes_tpu_torch.inflate_to_device(
                flush, g_index, device="cuda")[0][0].cpu()),
        "compress_batch (256 payloads, 32 KiB dictionary)": (
            "compress_batch(mesh=None)", lambda: P.compress_batch(
                payloads, zdict, device="cuda")),
    }


def parallel_phase(corpus: bytes, card: str, records: dict) -> dict:
    """Block parallelism through ``zlibes_tpu_torch.parallel`` on the full
    corpus: (a) a NCCL world of one on the card: the three encodes of
    ``tests/golden/parallel_bench.json`` (the reference's lengths and
    SHA-256), the three inflates of the earlier phases' streams and of the
    turbo stream just written, and the dictionary batch, each with its
    launches (counts zeroed just before the call and read just after), its
    whole-call time beside the single-device call's, its phases and its
    peak device memory; the encode kernels at the parallel path's shapes
    against their plain versions; (b) a gloo world of two ranks on the one
    card (two processes: NCCL refuses two ranks on one device), which must
    write the same bytes and raise CorruptError on every rank for a
    corrupted turbo stream.  Returns {kernel: {call: launches}}."""
    import torch.distributed as dist
    from zlibes_tpu_torch import parallel as P
    from zlibes_tpu_torch.ops import turbo_kernel as tk

    hold_parallel_kernels(corpus, records, card)
    per_kernel: dict = {}
    digests = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = P.make_mesh(device="cuda")
        assert mesh.group is not None and dist.get_backend() == "nccl"
        streams = parallel_streams(corpus)
        singles = single_device_calls(corpus, streams)
        for name, call, check, kernels in parallel_calls(corpus, streams,
                                                         mesh):
            tk.LAUNCHES.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = call()
            torch.cuda.synchronize()
            launches = dict(tk.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            check(res)
            comp = res[0] if isinstance(res, tuple) else res
            if isinstance(comp, bytes):
                digests[name] = hashlib.sha256(comp).hexdigest()
            for k, n in launches.items():
                per_kernel.setdefault(k, {})[name] = n
            P.LAST_TIMINGS.clear()
            call_s = wall_s(call)
            phases = {k: (v / 5 * 1e3 if k != "dispatches" else v / 5)
                      for k, v in P.LAST_TIMINGS.items()}
            line = (f"parallel (NCCL world of 1) {name}: launches "
                    f"{launches}; whole call {call_s * 1e3:.2f} ms (median of"
                    f" 5); phases a call (ms, mean of 5): " + ", ".join(
                        f"{k} {v:.2f}" for k, v in phases.items())
                    + f"; peak device memory {peak / 2**20:.1f} MiB")
            if name in singles:
                what, single = singles[name]
                line += (f"; beside it {what} {wall_s(single) * 1e3:.2f} ms "
                         f"(median of 5)")
            print(line + f" {card}")
            trace = profile_pipeline(call, card, runs=2,
                                     quiet=not name.startswith(
                                         "parallel_deflate"))
            if trace:
                print(f"parallel {name}: device busy {trace.busy:.4f} of "
                      f"{call_s * 1e3:.2f} ms per untraced call -> idle "
                      f"share {1 - trace.busy / (call_s * 1e3):.3f} {card}")
            for k in kernels:
                assert launches.get(k), f"{name} launched no {k}"
    finally:
        dist.destroy_process_group()
    parallel_world_of_two(digests, card)
    return per_kernel


def parallel_world_of_two(digests: dict, card: str) -> None:
    """Two ranks of ``chip_smoke.py --parallel-rank`` in a gloo world on the
    one card, both on ``cuda:0``: their bytes must be the world of one's,
    and a corrupted turbo stream must raise CorruptError on both."""
    import tempfile

    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank",
             str(r), addr, out], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=PARALLEL_RANK_TIMEOUT)[0]
                            .decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        ranks = [json.loads((Path(out) / f"rank{r}.json").read_text())
                 for r in range(2)]
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        for name, sha in res["sha256"].items():
            assert sha == digests[name], (r, name)
        assert res["corrupt"]["raised"] == "CorruptError", (r, res)
        print(f"parallel (gloo world of 2 on one card) rank {r} on "
              f"{res['device']}: bytes equal the world of one's "
              f"({', '.join(res['sha256'])}); whole call ms (one run after "
              f"one warm-up): " + ", ".join(
                  f"{k} {v:.2f}" for k, v in res["ms"].items())
              + f"; corrupted turbo stream: CorruptError in "
              f"{res['corrupt']['s']:.2f} s (own fault: "
              f"{res['corrupt']['own']}); launches "
              f"{res['launches']} {card}")
    assert sorted(r["corrupt"]["own"] for r in ranks) == [False, True]
    print(f"parallel world of 2: {wall:.1f} s wall for both processes, "
          f"start to exit {card}")


def parallel_rank(rank: int, addr: str, out: str) -> None:
    """One rank of ``parallel_world_of_two``: gloo, kernels on ``cuda:0``."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_parallel_worker import corrupt_payload
    from zlibes_tpu_torch import CorruptError
    from zlibes_tpu_torch import parallel as P
    from zlibes_tpu_torch.bench_corpus import bench_data
    from zlibes_tpu_torch.ops import turbo_kernel as tk

    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}", rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=PARALLEL_RANK_TIMEOUT // 2))
    mesh = P.make_mesh(device="cuda")
    assert mesh.device == torch.device("cuda", 0) and mesh.size == 2
    corpus = bench_data()
    streams = parallel_streams(corpus)
    turbo, t_index = streams["turbo"]
    wide, w_index = streams["wide"]
    calls = {
        "parallel_deflate dynamic": lambda: P.parallel_deflate(corpus, mesh),
        "parallel_deflate turbo": lambda: P.parallel_deflate(
            corpus, mesh, turbo=True, with_index=True),
        "parallel_inflate turbo_bench": lambda: P.parallel_inflate(
            turbo, t_index, mesh),
        "parallel_inflate wide_bench": lambda: P.parallel_inflate(
            wide, w_index, mesh),
    }
    res = dict(device=str(mesh.device), sha256={}, ms={}, launches={})
    for name, call in calls.items():
        call()
        tk.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        res["ms"][name] = (time.perf_counter() - t0) * 1e3
        res["launches"][name] = dict(tk.LAUNCHES)
        got = got[0] if isinstance(got, tuple) else got
        if name.startswith("parallel_inflate"):
            assert got == corpus, name
        res["sha256"][name] = hashlib.sha256(got).hexdigest()
    bad = corrupt_payload(turbo, t_index)
    t0 = time.perf_counter()
    try:
        P.parallel_inflate(bad, t_index, mesh)
        res["corrupt"] = dict(raised=None)
    except CorruptError as exc:
        res["corrupt"] = dict(raised="CorruptError",
                              own=exc.__cause__ is not None)
    res["corrupt"]["s"] = time.perf_counter() - t0
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import zlibes_tpu_torch
    from zlibes_tpu_torch import ChecksumError, CorruptError, StreamIndex
    from zlibes_tpu_torch.bench_corpus import bench_data
    from zlibes_tpu_torch.codec import turbo as tb
    from zlibes_tpu_torch.ops import turbo_kernel as tk
    from zlibes_tpu_torch.ops.adler32 import adler32_device
    from zlibes_tpu_torch.runtime import kernels, native

    # -- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    card = f"[{smi}]"

    # -- 2. build the kernels from the checkout's sources
    t0 = time.perf_counter()
    kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(str(s.relative_to(ROOT)) for s in kernels.sources())}"
          f" -> {kernels.library_path().relative_to(ROOT)})")
    # the host runtime for streams without an index, from the port's own
    # zscan.cc: a CPython level-6 stream comes back through the public call
    t0 = time.perf_counter()
    assert native.available(), "the port's native runtime did not build"
    raw = (GOLDEN / "raw.bin").read_bytes()
    foreign = zlib.compress(raw, 6)
    assert zlibes_tpu_torch.inflate(foreign) == raw
    print(f"native: {time.perf_counter() - t0:.2f} s to build "
          f"zlibes_tpu_torch/runtime/zscan.cc into "
          f"{native.BUILD_DIR.relative_to(ROOT)} and inflate a CPython "
          f"level-6 stream of {len(raw)} B without an index")
    # and with the index build_index makes for it: chained blocks, which no
    # kernel takes, so the call decodes on the host and checks the index
    f_index = zlibes_tpu_torch.build_index(foreign)
    assert not f_index.self_contained and not f_index.wide
    tk.LAUNCHES.clear()
    assert zlibes_tpu_torch.inflate(foreign, index=f_index) == raw
    assert not tk.LAUNCHES, dict(tk.LAUNCHES)
    other = zlib.compress(raw[:-1], 6)
    try:
        zlibes_tpu_torch.inflate(other, index=f_index)
    except CorruptError as exc:
        print(f"native: inflate(index=build_index(stream)) of the same "
              f"stream ({len(f_index.blocks)} chained blocks, "
              f"{f_index.anchor_bit.size} anchors) byte-exact on the host; "
              f"the index on another stream: CorruptError ({exc})")
    else:
        raise AssertionError("an index of another stream was accepted")

    # -- 3. the committed fixture and the corpus it encodes
    comp = (GOLDEN / "turbo_bench.zz").read_bytes()
    index = StreamIndex.load(GOLDEN / "turbo_bench.idx.npz")
    corpus = bench_data()
    assert index.turbo
    assert zlib.decompress(comp) == corpus, "fixture does not encode the corpus"
    plan = tb.TurboPlan.build(comp, index, "cuda")
    print(f"fixture: corpus {len(corpus)} B, stream {len(comp)} B, "
          f"{len(index.blocks)} blocks, L={plan.L} lanes (L_pad={plan.L_pad}), "
          f"C_pad={plan.C_pad} chunk rows")

    # -- 4. each kernel against its plain version, at the fixture's shapes
    records = {}
    win = tk.lane_windows(plan.words, plan.start_w)
    torch.cuda.synchronize()
    win_p = tk.lane_windows_plain(plan.words, plan.start_w)
    assert torch.equal(win, win_p), "lane_windows != plain"
    records["lane_windows"] = dict(
        replaces=f"{TURBO_SRC}:192,239", max_abs_err=max_abs_err(win, win_p),
        ms=cuda_ms(lambda: tk.lane_windows(plan.words, plan.start_w)),
        plain_ms=cuda_ms(lambda: tk.lane_windows_plain(plan.words,
                                                       plan.start_w),
                         runs=10),
        shape=list(win.shape),
        # ~4 operations an output word (index, two compares, select)
        **bound(nbytes(plan.words, plan.start_w, win), 4 * win.numel()))

    # the form the pipeline calls: the kernel stages the windows itself from
    # the stream's words; held against the plain decode of the plain windows
    lane_args = (plan.bit0, plan.endb, plan.lt, plan.dt)
    src = (plan.words, plan.start_w)
    tokens, meta = tk.decode_turbo(src, *lane_args)
    torch.cuda.synchronize()
    tokens_p, meta_p = tk.decode_turbo_plain(win_p, *lane_args)
    err = hold_decode("decode_turbo((words, start_w))", (tokens, meta),
                      (tokens_p, meta_p), plan.T)
    # and given the windows (the stand-alone kernel's), as the tests call it
    err = max(err, hold_decode("decode_turbo(win)",
                               tk.decode_turbo(win, *lane_args),
                               (tokens_p, meta_p), plan.T))
    plan.check_meta(meta.cpu().numpy())
    records["decode_turbo"] = dict(
        replaces=f"{TURBO_SRC}:496", max_abs_err=err,
        ms=cuda_ms(lambda: tk.decode_turbo(src, *lane_args)),
        plain_ms=cuda_ms(lambda: tk.decode_turbo_plain(
            tk.lane_windows_plain(*src), *lane_args), runs=10),
        shape=list(tokens.shape), tokens=int(meta[0].sum()))
    # read: the stream's words and the per-lane arrays; written: the emitted
    # tokens and the meta rows; ~60 operations a token (bit fetch, two table
    # lookups, the checks)
    n_tok = records["decode_turbo"]["tokens"]
    records["decode_turbo"].update(bound(
        nbytes(*src, *lane_args, meta) + 4 * n_tok, 60 * n_tok))

    toks16, starts16 = tb._glue_tokens(tokens, meta[0], plan.base, plan.C_pad)
    rows = tk.resolve_turbo(toks16, starts16)
    torch.cuda.synchronize()
    rows_p = tk.resolve_turbo_plain(toks16, starts16)
    assert torch.equal(rows, rows_p), "resolve_turbo != plain"
    assert rows.reshape(-1)[: plan.total_out].cpu().numpy().tobytes() == corpus
    records["resolve_turbo"] = dict(
        replaces=f"{TURBO_SRC}:621", max_abs_err=max_abs_err(rows, rows_p),
        ms=cuda_ms(lambda: tk.resolve_turbo(toks16, starts16)),
        plain_ms=cuda_ms(lambda: tk.resolve_turbo_plain(toks16, starts16),
                         runs=10),
        shape=list(rows.shape),
        # ~80 operations a byte (9 search steps, the jump rounds)
        **bound(nbytes(toks16, starts16, rows), 80 * rows.numel()))
    for name, r in records.items():
        print(f"kernel {name}: exact vs plain (max_abs_err {r['max_abs_err']}),"
              f" kernel {r['ms']:.4f} ms (median of 20), plain "
              f"{r['plain_ms']:.4f} ms (median of 10), "
              f"shape {r['shape']} {card}")
    turbo_other_inputs(plan, win, records, card)
    glue_ms = cuda_ms(lambda: tb._glue_tokens(tokens, meta[0], plan.base,
                                              plan.C_pad))
    flat = rows.reshape(-1)[: plan.total_out]
    adler_ms = cuda_ms(lambda: adler32_device(flat))
    print(f"torch ops: glue {glue_ms:.4f} ms, adler32 {adler_ms:.4f} ms, "
          f"median of 20 {card}")

    # -- 5. end to end through the public entry point
    tk.LAUNCHES.clear()
    out = zlibes_tpu_torch.inflate(comp, index=index, device="cuda")
    launches = dict(tk.LAUNCHES)
    assert out == corpus, "inflate(device='cuda') output != corpus"
    print(f"inflate(device='cuda'): {len(out)} B byte-exact, "
          f"Adler-32 verified on the device; launches {launches}")
    assert launches == {"decode_turbo": 1, "resolve_turbo": 1}, launches

    trailer = int.from_bytes(comp[-4:], "big")

    def device_pipeline():
        rows = tb.run_turbo(plan, check=False)
        return adler32_device(rows.reshape(-1)[: plan.total_out])

    assert int(device_pipeline()) == trailer
    pipe_ms = cuda_ms(device_pipeline)
    call_s = wall_s(lambda: zlibes_tpu_torch.inflate(comp, index=index,
                                                     device="cuda"))
    plan_s = wall_s(lambda: tb.TurboPlan.build(comp, index, "cuda"))
    zlib_s = wall_s(lambda: zlib.decompress(comp))
    n = len(corpus)
    print(f"host: TurboPlan.build (tables, lane spans, copies to the card) "
          f"{plan_s * 1e3:.2f} ms, median of 5 {card}")
    print(f"device pipeline (plan prebuilt, stream on device; decode with "
          f"its windows + glue + resolve + adler32): {pipe_ms:.4f} ms -> "
          f"{n / pipe_ms / 1e6:.3f} GB/s of output, median of 20 {card}")
    print(f"whole inflate() call, host to host: {call_s * 1e3:.2f} ms -> "
          f"{n / call_s / 1e9:.3f} GB/s, median of 5 {card}")
    print(f"CPython zlib.decompress, one core: {zlib_s * 1e3:.2f} ms -> "
          f"{n / zlib_s / 1e9:.3f} GB/s, median of 5 (host CPU beside {card})")
    device_ms = profile_pipeline(device_pipeline, card)
    if device_ms:
        busy = device_ms.busy
        print(f"untraced device pipeline: device busy {busy:.4f} of "
              f"{pipe_ms:.4f} ms -> idle share {1 - busy / pipe_ms:.3f} "
              f"(host launch-bound where high) {card}")
    lane_report("decode_turbo", records["decode_turbo"], tokens, meta[0],
                tk.TOK_MATCH_BIT, device_time(device_ms, "decode_turbo"),
                card)
    records["lane_windows"]["device_ms"] = lane_windows_device_ms(
        plan.words, plan.start_w, tk.STREAM_WORDS, card)

    # -- 6. corruption probe
    rng = np.random.default_rng(3)
    raised = 0
    for _ in range(6):
        bad = bytearray(comp)
        pos = int(rng.integers(16, len(bad) - 8))
        bad[pos] ^= int(rng.integers(1, 256))
        try:
            got = zlibes_tpu_torch.inflate(bytes(bad), index=index,
                                           device="cuda")
        except (CorruptError, ChecksumError) as exc:
            raised += 1
            print(f"corruption at byte {pos}: {type(exc).__name__}")
        else:
            assert got == corpus, f"flip at byte {pos} decoded to wrong bytes"
            print(f"corruption at byte {pos}: in a bit gap, output unchanged")
    assert raised >= 4, f"only {raised} of 6 corruptions detected"

    records["lane_windows"]["note"] = (
        "launched by no path: decode_turbo and decode_wide stage the same "
        "windows in shared memory (stage_windows, "
        "zlibes_tpu_torch/csrc/lane_decode.cuh); its numbers are the "
        "stand-alone kernel's at widths 96 and SW")
    wide_launches, wide_device_ms = wide_phase(corpus, card, records)
    for name, n in wide_launches.items():
        launches[name] = launches.get(name, 0) + n
    enc_launches, enc_device_ms = encode_phase(corpus, card, records)
    for name in ("select_turbo", "encode_fields"):
        launches[name] = enc_launches[name]
    gen_launches, _ = general_phase(corpus, card, records)
    for name in ("select_tokens", "block_tables"):
        launches[name] = gen_launches[name]
    generic_launches, _ = generic_phase(corpus, card, records)
    for name in ("decode_tokens", "resolve_global"):
        launches[name] = generic_launches[name]
    decode_tables_phase(card, records)
    shared_launches = shared_phase(corpus, card, records)
    par_launches = parallel_phase(corpus, card, records)

    st = records["select_tokens"]
    turbo_ms = device_time(enc_device_ms, "select_turbo")
    print(f"select_tokens device a launch: bench dispatch "
          f"{st['device_ms']:.4f} ms, incompressible dispatch "
          f"{st['the incompressible dispatch']['device_ms']:.4f} ms; beside "
          f"it select_turbo {turbo_ms:.4f} ms a launch (torch.profiler) "
          f"{card}")

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "zlibes_tpu"))
    assert not loaded, f"the port pulled in {loaded}"

    wide = ("wide_lanes", "decode_wide", "resolve_wide")
    encode = ("select_turbo", "select_tokens", "encode_fields",
              "block_tables")
    generic = ("decode_tokens", "resolve_global")
    entries = []
    for name, r in records.items():
        group = ("wide" if name in wide else
                 "encode" if name in encode else
                 "inflate" if name in generic else "turbo")
        entries.append({
            "name": name, "route": "cuda",
            "source": r.get("source",
                            f"zlibes_tpu_torch/csrc/{group}_kernels.cu"),
            "replaces": r["replaces"], "launches": launches.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "bytes": r["bytes"], "ops": r["ops"],
            "device_ms": r["device_ms"] if "device_ms" in r else device_time(
                {"wide": wide_device_ms, "encode": enc_device_ms}.get(
                    group, device_ms), name),
            "parallel_launches": par_launches.get(name, {}),
            "shared_launches": {cfg: n.get(name, 0)
                                for cfg, n in shared_launches.items()}})
        entries[-1].update({k: r[k] for k in (
            "wide_ms", "wide_plain_ms", "wide_device_ms", "wide_bound_ms",
            "tokens", "longest_lane_tokens", "mean_lane_tokens",
            "longest_lane_steps", "mean_lane_steps",
            "mean_warp_longest_steps", "sm_mhz", "cycles_per_token",
            "cycles_per_step", "expand_ms", "rounds_ms", "rounds",
            "rounds_with_work", "the bench dispatch",
            "the incompressible dispatch", "note", "split_far off",
            "split_far on, seg 1024", "split_far off, seg 512",
            "fields over 32 bits", "shared_device_ms", "wide plan",
            "the fixture", "plan_ms")
            if k in r})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
