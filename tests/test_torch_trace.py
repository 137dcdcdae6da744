"""The port's named stage spans (``zlibes_tpu_torch.config.trace``) against
the JAX package's (``zlibes_tpu.config.trace``), and the spans of every
public call of the port in a ``torch.profiler`` trace.

Both encoders get the same seeded inputs; a recorder put in place of each
pipeline's ``trace`` and of the port's ``config.trace``, which its
``@span`` roots call (it still enters the real span), lists the names each
one enters.  In every case the port enters each name the JAX package
enters as often as the JAX package, and writes the same bytes: one span of
each stage a dispatch (turbo: match, select, symbols, pack; general:
match, select, symbols), and match and select once more a dispatch when
the turbo encode runs them again in its second phase.  The names only the
port enters (the call's root ``zlibes.deflate``, its uploads, readbacks,
tables, entropy, pack on the general path, splice and the trailer's
Adler-32) have exact counts of their own, a dispatch and a call.

The later tests read real ``torch.profiler`` traces on the CPU: each
public call enters exactly one root span, every other ``zlibes.*`` span
lies inside it, each name as often as the call's dispatches say, and every
``CodecStats.stage_s`` and ``LAST_TIMINGS`` key comes with a span of its
name.
"""
import collections
import dataclasses
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import zlibes_tpu
from zlibes_tpu.codec import deflate_pipeline as jdp
from zlibes_tpu.config import CodecConfig as JaxCodecConfig

import zlibes_tpu_torch
from zlibes_tpu_torch import CodecConfig, CodecStats, config_from_reference
from zlibes_tpu_torch import config as tconfig
from zlibes_tpu_torch import parallel as P
from zlibes_tpu_torch.codec import deflate_pipeline as tdp
from zlibes_tpu_torch.config import trace
from zlibes_tpu_torch.spec import constants as TC
from zlibes_tpu_torch.spec import refmodel as trm

torch.set_num_threads(2)

BP = 2          # blocks a dispatch
TURBO = ("zlibes.match", "zlibes.select", "zlibes.symbols", "zlibes.pack")
GENERAL = ("zlibes.match", "zlibes.select", "zlibes.symbols")
RAW = (Path(__file__).resolve().parent / "golden" / "raw.bin").read_bytes()

# the spans only the port enters: (a dispatch, a call); the general encoder
# reads its packed words back once more in every dispatch with a coded
# block (``coded_readback``)
PORT_TURBO = ({"zlibes.upload": 1},
              {"zlibes.deflate": 1, "zlibes.entropy": 2, "zlibes.readback": 2,
               "zlibes.upload": 1, "zlibes.splice": 1})
PORT_GENERAL = ({"zlibes.upload": 1, "zlibes.readback": 1,
                 "zlibes.tables": 1, "zlibes.pack": 1, "zlibes.splice": 1},
                {"zlibes.deflate": 1, "zlibes.adler": 1, "zlibes.upload": 1,
                 "zlibes.readback": 1})


def _expected(per_dispatch: dict, per_call: dict, dispatches: int,
              coded_readback: int = 0) -> dict:
    want = collections.Counter(per_call)
    for name, k in per_dispatch.items():
        want[name] += k * dispatches
    want["zlibes.readback"] += coded_readback
    return dict(want)


def _coded_dispatches(stream: bytes, dictionary, block_size: int,
                      per: int) -> int:
    """Dispatches of ``per`` blocks of ``block_size`` bytes with a coded
    (not stored) block in the zlib ``stream``, read by the host model."""
    offset = 6 if stream[1] & 0x20 else 2
    res = trm.inflate_raw(stream, offset, dictionary=dictionary)
    return len({b.out_start // (block_size * per) for b in res.blocks
                if b.btype != TC.BTYPE_STORED and b.out_len})


def _mixed_data(n=40000, seed=0):
    rng = np.random.default_rng(seed)
    text = (b"the quick brown fox jumps over the lazy dog. " * 200)
    rnd = rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes()
    rle = b"A" * 1200 + b"ab" * 700 + bytes(range(256)) * 4
    out = (text + rnd + rle) * 3
    return out[:n]


_TURBO = dataclasses.replace(JaxCodecConfig.turbo(candidates=4,
                                                  probe_words=4),
                             blocks_per_dispatch=BP)
_LEVEL6 = dataclasses.replace(JaxCodecConfig.from_level(6),
                              blocks_per_dispatch=BP)

# name: (reference config or None for deflate_indexed, block size, data
# length, dictionary length, the reference's spans a dispatch)
CASES = {
    "turbo": (_TURBO, 16384, 5 * 16384 + 123, 0,
              {n: 1 for n in TURBO}),
    # beyond phase1_cache_blocks phase 2 runs match and select again
    "turbo_recompute": (dataclasses.replace(_TURBO, phase1_cache_blocks=2),
                        16384, 5 * 16384 + 123, 0,
                        {**{n: 1 for n in TURBO}, "zlibes.match": 2,
                         "zlibes.select": 2}),
    "level6": (_LEVEL6, 8192, 40000, 0, {n: 1 for n in GENERAL}),
    "level0": (dataclasses.replace(JaxCodecConfig.from_level(0),
                                   blocks_per_dispatch=BP),
               8192, 40000, 0, {}),
    "level6_dictionary": (_LEVEL6, 8192, 30000, 1000,
                          {n: 1 for n in GENERAL}),
    "deflate_indexed": (None, 8192, 40000, 0, {n: 1 for n in GENERAL}),
}


class _Recorder:
    """Stands in for a pipeline's ``trace``: notes each name, then enters
    the span the pipeline would have entered."""

    def __init__(self, real):
        self.real, self.names = real, []

    def __call__(self, name, *args, **kw):
        self.names.append(name)
        return self.real(name, *args, **kw)


def _inputs(name):
    jcfg, bs, n, n_dict, _ = CASES[name]
    data = _mixed_data(n, seed=len(name))
    dictionary = _mixed_data(n_dict, seed=99) if n_dict else None
    return jcfg, bs, data, dictionary


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_enters_the_references_spans(name, monkeypatch):
    jcfg, bs, data, dictionary = _inputs(name)
    jrec = _Recorder(jdp.trace)
    trec = _Recorder(tdp.trace)
    monkeypatch.setattr(jdp, "trace", jrec)
    monkeypatch.setattr(tdp, "trace", trec)
    monkeypatch.setattr(tconfig, "trace", trec)
    if jcfg is None:
        want, _ = zlibes_tpu.deflate_indexed(data, block_size=bs)
        got, _ = zlibes_tpu_torch.deflate_indexed(data, block_size=bs,
                                                  device="cpu")
        per = CodecConfig().blocks_per_dispatch
    else:
        want = jdp.deflate(data, config=jcfg, block_size=bs,
                           dictionary=dictionary)
        got = zlibes_tpu_torch.deflate(
            data, config=config_from_reference(jcfg), block_size=bs,
            dictionary=dictionary, device="cpu")
        per = jcfg.blocks_per_dispatch
    assert got == want
    counts = collections.Counter(trec.names)
    jcounts = collections.Counter(jrec.names)
    dispatches = -(-(-(-len(data) // bs)) // per)
    assert dispatches >= (2 if jcfg is not None else 1)
    assert jcounts == {n: k * dispatches for n, k in CASES[name][4].items()}
    # every name the reference enters, as often; the port's own names have
    # their own counts
    assert {n: counts[n] for n in jcounts} == jcounts
    own = collections.Counter({n: k for n, k in counts.items()
                               if n not in jcounts})
    if name == "level0":
        port = _expected({}, PORT_GENERAL[1], 0)
    elif name.startswith("turbo"):
        # the second phase's match and select also upload the rows again
        port = _expected({"zlibes.upload": 2 if name == "turbo_recompute"
                          else 1}, PORT_TURBO[1], dispatches)
    else:
        port = _expected(*PORT_GENERAL, dispatches, _coded_dispatches(
            got, dictionary, bs, per))
    jnames = set(jcounts)
    assert own == {n: k for n, k in port.items() if n not in jnames}
    # pack on the general path is the port's own
    assert ("zlibes.pack" in own) == (name not in ("level0",)
                                      and not name.startswith("turbo"))


def test_trace_is_a_profiler_span():
    """Under a profiler a span is a ``record_function``: one user
    annotation of its name in the trace, holding what ran inside it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace("zlibes.x"):
            torch.ones(4).sum()
    (x,) = [e for e in prof.events() if e.name == "zlibes.x"]
    assert any(c.name == "aten::sum" for c in x.cpu_children)


def _profiled(fn):
    """(what ``fn()`` returned, [(name, start ns, end ns)] of the
    ``zlibes.*`` spans of a CPU ``torch.profiler`` trace of it).  The names
    are read from the trace's raw records: the plain ``select_tokens``
    records some 340,000 ops a dispatch, which ``prof.events()`` would take
    half a minute to build into a tree."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("zlibes.")]
    return out, spans


def test_torch_profiler_sees_every_span():
    """One dispatch of each encoder under a CPU ``torch.profiler`` trace:
    the reference's names once each, and the port's own."""
    data = _mixed_data(4096, seed=5)
    for cfg, names, port in (
            (CodecConfig.turbo(candidates=4, probe_words=4), TURBO,
             _expected(*PORT_TURBO, 1)),
            (CodecConfig.from_level(6), GENERAL,
             _expected(*PORT_GENERAL, 1, coded_readback=1))):
        _, spans = _profiled(lambda: zlibes_tpu_torch.deflate(
            data, config=cfg, block_size=4096, device="cpu"))
        seen = collections.Counter(n for n, _, _ in spans)
        want = collections.Counter(port)
        want.update(names)
        assert seen == want, seen


def test_a_span_times_its_stage_without_a_profiler():
    """``trace(name, into)`` adds the host seconds of every entry to the
    dict ``into`` (a ``CodecStats.stage_s``, ``LAST_TIMINGS``) under the
    name without its prefix, with or without a profiler; with none running
    the span is not entered."""
    from torch.profiler import ProfilerActivity, profile

    stats, timings = CodecStats(), {}
    for _ in range(2):
        with trace("zlibes.tables", stats.stage_s), \
                trace("zlibes.collective", timings):
            pass
    assert set(stats.stage_s) == {"tables"} and stats.stage_s["tables"] > 0
    assert set(timings) == {"collective"}
    # with no profiler and no clock, every stage is the one idle span
    assert trace("zlibes.splice") is trace("zlibes.match")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace("zlibes.splice", stats.stage_s), trace("zlibes.glue"):
            pass
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("zlibes.")] == ["zlibes.splice",
                                                    "zlibes.glue"]
    assert set(stats.stage_s) == {"tables", "splice"}


# -- every public call: one root span, every other span inside it

_ROOTS = {"zlibes.deflate", "zlibes.inflate", "zlibes.inflate_to_device",
          "zlibes.inflate_range", "zlibes.parallel_deflate",
          "zlibes.parallel_inflate", "zlibes.compress_batch"}
_DATA = RAW[:30000]             # four blocks of 8 KiB, each coded
_BS = 8192
_TURBO_CFG = dataclasses.replace(CodecConfig.turbo(candidates=4,
                                                   probe_words=4),
                                 blocks_per_dispatch=BP)
_LEVEL6_CFG = dataclasses.replace(CodecConfig.from_level(6),
                                  blocks_per_dispatch=BP)
_D = 2                          # dispatches of _DATA at BP blocks of _BS


def _stock_stream(data: bytes) -> bytes:
    """CPython zlib at level 6 and memLevel 4: blocks of 4,096 symbols,
    every one copying across the block boundary before it."""
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 4)
    return c.compress(data) + c.flush()


@pytest.fixture(scope="module")
def streams():
    """The turbo and the level-6 stream of ``_DATA`` with their indexes,
    and a stock-zlib stream of it with its chained ``build_index``."""
    out = {kind: tdp.deflate(_DATA, with_index=True, config=cfg,
                             block_size=_BS, device="cpu")
           for kind, cfg in (("turbo", _TURBO_CFG), ("wide", _LEVEL6_CFG))}
    chained = _stock_stream(_DATA)
    out["chained"] = (chained, zlibes_tpu_torch.build_index(
        chained, anchor_every=1024))
    return out


def _plan_spans(kind: str) -> dict:
    """A turbo plan uploads once and reads its lane ends back; a wide plan
    uploads the stream, then the anchors its lanes are built from, then
    builds the blocks' table rows from the stream (the blocks' input goes
    up, their statuses and the lanes' come back); a one-group plan of a
    chained index builds its rows the same way, then uploads its lanes
    (the stream's upload comes before the plan)."""
    if kind == "turbo":
        return {"zlibes.plan": 1, "zlibes.upload": 1, "zlibes.readback": 1}
    return {"zlibes.plan": 1, "zlibes.headers": 1, "zlibes.upload": 3,
            "zlibes.readback": 1}


def _decode_spans(kind: str, check: bool) -> dict:
    out = collections.Counter(_plan_spans(kind))
    out.update({"zlibes.decode": 1, "zlibes.glue": int(kind != "chained"),
                "zlibes.resolve": 1, "zlibes.readback": int(check)})
    return dict(out)


def _counts(*parts: dict) -> dict:
    out = collections.Counter()
    for p in parts:
        out.update(p)
    return {k: v for k, v in out.items() if v}


def _call(case: str, streams):
    """(root name, the call, its expected span counts, the CodecStats it
    fills or None, whether it fills LAST_TIMINGS)."""
    mesh = P.make_mesh(1, device="cpu")
    tc, ti = streams["turbo"]
    wc, wi = streams["wide"]
    stats = CodecStats()
    if case == "deflate_indexed_level6":
        return ("zlibes.deflate", lambda: tdp.deflate(
            _DATA, with_index=True, config=_LEVEL6_CFG, block_size=_BS,
            stats=stats, device="cpu"), _counts(
                {n: _D for n in GENERAL},
                _expected(*PORT_GENERAL, _D, coded_readback=_D)),
            stats, False)
    if case == "deflate_indexed_turbo":
        return ("zlibes.deflate", lambda: tdp.deflate(
            _DATA, with_index=True, config=_TURBO_CFG, block_size=_BS,
            stats=stats, device="cpu"), _counts(
                {n: _D for n in TURBO}, _expected(*PORT_TURBO, _D)),
            stats, False)
    if case == "inflate":
        return ("zlibes.inflate", lambda: zlibes_tpu_torch.inflate(
            tc, index=ti, device="cpu"), _counts(
                {"zlibes.inflate": 1, "zlibes.adler": 1,
                 "zlibes.readback": 2}, _decode_spans("turbo", True)),
            None, False)
    if case.startswith("inflate_to_device"):
        kind = case.rsplit("_", 1)[1]
        comp, index = streams[kind]
        return ("zlibes.inflate_to_device",
                lambda: zlibes_tpu_torch.inflate_to_device(
                    comp, index, device="cpu"),
                _counts({"zlibes.inflate_to_device": 1},
                        _decode_spans(kind, False)), None, False)
    if case.startswith("inflate_range"):
        kind = case.rsplit("_", 1)[1]
        comp, index = streams[kind]
        # a read across a block boundary: two blocks, one plan
        return ("zlibes.inflate_range",
                lambda: zlibes_tpu_torch.inflate_range(
                    comp, index, _BS - 100, 300, device="cpu"),
                _counts({"zlibes.inflate_range": 1, "zlibes.subindex": 1,
                         "zlibes.readback": 1},
                        _decode_spans(kind, True)), None, False)
    if case == "parallel_deflate":
        # one host stage and one dispatch a dispatch (match, select,
        # symbols), a second dispatch each to pack (symbols, pack); without
        # a group no collective
        return ("zlibes.parallel_deflate", lambda: P.parallel_deflate(
            _DATA, mesh, block_size=_BS), _counts(
                {"zlibes.parallel_deflate": 1, "zlibes.host_stage": 1,
                 "zlibes.dispatch": 2, "zlibes.match": 1,
                 "zlibes.select": 1, "zlibes.symbols": 2, "zlibes.pack": 1,
                 "zlibes.readback": 4, "zlibes.entropy": 1,
                 "zlibes.upload": 1, "zlibes.host_splice": 2}), None, True)
    if case == "parallel_inflate":
        return ("zlibes.parallel_inflate", lambda: P.parallel_inflate(
            tc, ti, mesh), _counts(
                {"zlibes.parallel_inflate": 1, "zlibes.host_stage": 1,
                 "zlibes.dispatch": 1, "zlibes.readback": 1},
                _decode_spans("turbo", True)), None, True)
    assert case == "compress_batch"
    payloads = [_DATA[:3000], _DATA[5000:6000], _DATA[9000:13000]]
    return ("zlibes.compress_batch", lambda: P.compress_batch(
        payloads, _DATA[-20000:], mesh, device="cpu"), _counts(
            {"zlibes.compress_batch": 1, "zlibes.host_stage": 2,
             "zlibes.dispatch": 1, "zlibes.match": 1, "zlibes.select": 1,
             "zlibes.symbols": 1, "zlibes.pack": 1, "zlibes.readback": 3,
             "zlibes.host_splice": 1}), None, True)


PUBLIC_CALLS = ["deflate_indexed_level6", "deflate_indexed_turbo", "inflate",
                "inflate_to_device_turbo", "inflate_to_device_wide",
                "inflate_to_device_chained", "inflate_range_wide",
                "inflate_range_turbo", "parallel_deflate", "parallel_inflate", "compress_batch"]


@pytest.mark.parametrize("case", PUBLIC_CALLS)
def test_a_public_call_is_one_root_span(case, streams):
    root, fn, want, stats, timed = _call(case, streams)
    P.LAST_TIMINGS.clear()
    _, spans = _profiled(fn)
    roots = [s for s in spans if s[0] in _ROOTS]
    assert [r[0] for r in roots] == [root]
    _, r0, r1 = roots[0]
    # every other span lies inside the root, so has a parent on the thread
    assert all(r0 <= s <= e <= r1 for _, s, e in spans)
    assert collections.Counter(n for n, _, _ in spans) == want
    names = {n for n, _, _ in spans}
    keys = set(stats.stage_s) if stats is not None else set()
    if timed:
        keys |= set(P.LAST_TIMINGS) - {"dispatches"}
        assert P.LAST_TIMINGS["dispatches"] == want["zlibes.dispatch"]
    assert bool(keys) == (stats is not None or timed)
    assert all(f"zlibes.{k}" in names for k in keys), (keys, names)


@pytest.mark.parametrize("kind", ["wide", "chained"])
def test_headers_lie_in_their_plan(kind, streams, monkeypatch):
    """``zlibes.headers`` is entered once a wide plan and once a plan of
    the group decode (groups of a block each here: every group's rows in
    one launch), inside its ``zlibes.plan``; the blocks' input goes up and
    their statuses come back inside it, once each."""
    from zlibes_tpu_torch.codec import inflate_pipeline as ip

    comp, index = streams[kind]
    if kind == "chained":
        monkeypatch.setattr(ip, "_LANES", 4)
    _, spans = _profiled(lambda: zlibes_tpu_torch.inflate_to_device(
        comp, index, device="cpu"))

    def of(name):
        return [(s, e) for n, s, e in spans if n == name]

    (plan,) = of("zlibes.plan")
    heads = of("zlibes.headers")
    groups = (len(ip.plan_groups(comp, index, "cpu")) if kind == "chained"
              else 1)
    assert len(heads) == 1 and (kind == "wide" or groups >= 3)
    assert all(plan[0] <= s <= e <= plan[1] for s, e in heads)
    for child in ("zlibes.upload", "zlibes.readback"):
        held = [u for u in of(child)
                if any(s <= u[0] <= u[1] <= e for s, e in heads)]
        assert len(held) == 1, child
