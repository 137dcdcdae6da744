"""The port's named stage spans (``zlibes_tpu_torch.config.trace``) against
the JAX package's (``zlibes_tpu.config.trace``).

Both encoders get the same seeded inputs; a recorder put in place of each
pipeline's ``trace`` (it still enters the real span) lists the names each
one enters.  In every case the port enters the same ``zlibes.*`` names, each
as often, as the JAX package, and writes the same bytes.  The count is one
span of each stage a dispatch (turbo: match, select, symbols, pack;
general: match, select, symbols), and match and select once more a
dispatch when the turbo encode runs them again in its second phase.  The
last test finds the names in a real ``torch.profiler`` trace.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

import zlibes_tpu
from zlibes_tpu.codec import deflate_pipeline as jdp
from zlibes_tpu.config import CodecConfig as JaxCodecConfig

import zlibes_tpu_torch
from zlibes_tpu_torch import CodecConfig, config_from_reference
from zlibes_tpu_torch.codec import deflate_pipeline as tdp
from zlibes_tpu_torch.config import trace

torch.set_num_threads(2)

BP = 2          # blocks a dispatch
TURBO = ("zlibes.match", "zlibes.select", "zlibes.symbols", "zlibes.pack")
GENERAL = ("zlibes.match", "zlibes.select", "zlibes.symbols")


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
# length, dictionary length, spans a dispatch)
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

    def __call__(self, name):
        self.names.append(name)
        return self.real(name)


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
    assert counts == collections.Counter(jrec.names)
    dispatches = -(-(-(-len(data) // bs)) // per)
    assert dispatches >= (2 if jcfg is not None else 1)
    assert counts == {n: k * dispatches
                      for n, k in CASES[name][4].items()}


def test_trace_is_a_profiler_span():
    assert isinstance(trace("zlibes.x"), torch.profiler.record_function)


def test_torch_profiler_sees_every_span():
    """One dispatch of each encoder under a CPU ``torch.profiler`` trace.
    The names are read from the trace's raw records: the plain
    ``select_tokens`` records some 340,000 ops a dispatch, which
    ``prof.events()`` would take half a minute to build into a tree."""
    from torch.profiler import ProfilerActivity, profile

    data = _mixed_data(4096, seed=5)
    for cfg, names in ((CodecConfig.turbo(candidates=4, probe_words=4),
                        TURBO), (CodecConfig.from_level(6), GENERAL)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            zlibes_tpu_torch.deflate(data, config=cfg, block_size=4096,
                                     device="cpu")
        seen = collections.Counter(
            e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("zlibes."))
        assert seen == {n: 1 for n in names}, seen
