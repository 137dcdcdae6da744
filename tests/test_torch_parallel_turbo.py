"""``zlibes_tpu_torch.parallel`` in a gloo world of 2 ranks and a world of
one: the turbo profile's encode and inflate, the reference's digests in
``tests/golden/parallel_bench.json``, errors that every rank agrees on,
and the two functions the sharded encode adds to the port
(``pack_payload_turbo`` and the Adler-32 shard combine) against the JAX
package's.

``parallel_bench.json`` holds what the reference's ``parallel_deflate``
wrote on an 8-device CPU mesh (``tools/make_torch_fixture.py``); its
bytes do not depend on the mesh size, so every world here must give them.
"""
import hashlib
import json
import zlib as pyzlib
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_worker as w

import zlibes_tpu_torch as zt
from zlibes_tpu_torch import parallel as P
from zlibes_tpu_torch.codec import deflate_pipeline as dp
from zlibes_tpu_torch.codec.framing import stage_rows
from zlibes_tpu_torch.ops import block_tables as bt
from zlibes_tpu_torch.ops.adler32 import adler_partials, adler_value
from zlibes_tpu_torch.ops.deflate_kernel import (pack_payload_turbo,
                                                 token_symbols)
from zlibes_tpu_torch.ops.encode_kernel import pack_tables
from zlibes_tpu_torch.ops.entropy import limited_lengths_pair
from zlibes_tpu_torch.ops.lz77 import find_matches

torch.set_num_threads(2)

FIXTURE = json.loads((Path(__file__).parent / "golden"
                      / "parallel_bench.json").read_text())
MODES = list(w.PREFIX_MODES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return w.run_world("turbo", 2, tmp_path_factory.mktemp("turbo"))


@pytest.fixture(scope="module")
def world1():
    """The prefix modes in a world of one, in this process."""
    mesh = P.make_mesh(1, device="cpu")
    return {mode: P.parallel_deflate(w.RAW[: w.PREFIX], mesh, **kw)
            for mode, kw in w.PREFIX_MODES.items()}


def _hold(comp: bytes, mode: str) -> None:
    want = FIXTURE["prefix"][mode]
    assert want["args"] == w.PREFIX_MODES[mode]
    assert len(comp) == want["length"]
    assert hashlib.sha256(comp).hexdigest() == want["sha256"]
    assert pyzlib.decompress(comp) == w.RAW[: w.PREFIX]


def test_fixture_holds_the_reference_lengths():
    full = FIXTURE["corpus"]
    assert full["bytes_in"] == 3843200 and FIXTURE["mesh"] == 8
    assert [full[m]["length"] for m in MODES] == [1577211, 1964332, 1616828]
    assert [FIXTURE["prefix"][m]["length"] for m in MODES] == [
        36313, 45769, 37374]


@pytest.mark.parametrize("mode", MODES)
def test_world_of_two_gives_the_reference_bytes(world, mode):
    _hold(w.value(world, "prefix")[mode], mode)


@pytest.mark.parametrize("mode", MODES)
def test_world_of_one_gives_the_reference_bytes(world1, mode):
    res = world1[mode]
    _hold(res[0] if isinstance(res, tuple) else res, mode)


def test_parallel_turbo_roundtrip(world):
    """The turbo profile under the mesh: its index is the reference's
    (the digest of its arrays), carries the turbo flag, and drives the
    sharded turbo inflate back to the input."""
    res = w.value(world, "prefix")
    idx = res["turbo_index"]
    want = FIXTURE["prefix"]["turbo"]["index"]
    index = zt.StreamIndex([zt.spec.refmodel.BlockInfo(*b)
                            for b in idx["blocks"]], idx["anchor_bit"],
                           idx["anchor_out"], idx["anchor_block"])
    assert w.index_sha256(index) == want["sha256"]
    assert (len(idx["blocks"]), idx["anchor_bit"].size, idx["max_tokens"]) \
        == (want["blocks"], want["anchors"], want["max_tokens"])
    assert idx["turbo"] and idx["chunk_reset"] == 4096
    assert res["turbo_inflated"] == w.RAW[: w.PREFIX]


def test_world_of_one_turbo_index_equals_reference(world1):
    comp, index = world1["turbo"]
    assert index.turbo
    assert w.index_sha256(index) == FIXTURE["prefix"]["turbo"]["index"][
        "sha256"]
    assert P.parallel_inflate(comp, index, P.make_mesh(1, device="cpu")) \
        == w.RAW[: w.PREFIX]


def test_parallel_turbo_inflate_of_host_stream(world):
    """A turbo stream of the single-device encoder decodes on the mesh."""
    assert w.value(world, "host_stream") == w.RAW[:98304]


@pytest.mark.parametrize("case", ["corrupt_turbo", "corrupt_wide",
                                  "corrupt_generic"])
def test_corrupt_stream_raises_on_every_rank(world, case):
    """A fault in the last rank's span only: every rank raises
    CorruptError (the others learn it from the status all_reduce), and
    none is left waiting in the output gather."""
    got = [r.get("value", r) for r in world[case]]
    assert [g.get("raised") for g in got] == ["CorruptError"] * 2, got
    assert [g["own"] for g in got] == [False, True]


def test_parallel_inflate_splices_stored_blocks(world):
    """Stored blocks between and after coded ones, and a stream of stored
    blocks only (no anchor lanes: rank 0 copies them all)."""
    res = w.value(world, "stored_blocks")
    assert res["mixed"] == w.stored_data()
    assert res["stored"] == w.stored_data()


def _turbo_tokens(data: bytes, N: int):
    """Phase 1 of the sharded turbo encode on ``data``'s blocks."""
    B = -(-len(data) // N)
    rows, nv = stage_rows(lambda i: data[i * N : (i + 1) * N], 0, B, N)
    rows, nv = torch.from_numpy(rows), torch.from_numpy(nv)
    matches = find_matches(rows, nv, N=N, S=16, J=16, reset=4096,
                           two_phase=True)
    tv, td, cnt = dp.select_glue(rows, matches, nv, N, lazy=True)
    return tv, td, cnt, token_symbols(tv, td, cnt, nseg=N // 512)


def test_pack_payload_turbo_matches_reference():
    """The per-block W-word turbo pack against the JAX package's on the
    same tokens and shared tables: payload ends, lane starts, split
    anchors, and each block's words up to its payload end."""
    import jax.numpy as jnp
    from zlibes_tpu.ops.deflate_kernel import pack_payload_turbo as jpack

    N = 16384
    nseg = N // 512
    W = (15 * N + 4096) // 32
    R = zt.CodecConfig.turbo().pack_row_width(512)
    tv, td, cnt, (_ls, _ds, valid, llf, dfq) = _turbo_tokens(
        w.RAW[:40000], N)
    B = llf.shape[0]
    ll_len, d_len = (x.long().numpy() for x in limited_lengths_pair(
        llf.sum(0), dfq.sum(0), 9))
    ll_code, d_code = bt._encode_tables(ll_len, d_len)
    hdr = np.array([253, 261, 250][:B], np.int32)
    lt, dt = pack_tables(ll_code, ll_len, d_code, d_len)
    got = pack_payload_turbo(tv, td, valid, lt, dt, torch.from_numpy(hdr),
                             nseg=nseg, W=W, R=R)

    def rows(x, dtype):
        return jnp.asarray(np.broadcast_to(x, (B, x.size)).astype(dtype))

    want = jpack(jnp.asarray(tv.numpy()), jnp.asarray(td.numpy()),
                 jnp.asarray(valid.numpy()), rows(ll_code, np.uint32),
                 rows(ll_len, np.int32), rows(d_code, np.uint32),
                 rows(d_len, np.int32), jnp.asarray(hdr),
                 jnp.ones(B, bool), nseg=nseg, W=W, R=R)
    for name, g, x in zip(("payload_end", "lane_bit0", "split_bit",
                           "split_out"), got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(x)), name
    words = got[0].numpy()
    jwords = np.asarray(want[0]).astype(np.int64)
    for b in range(B):
        used = (int(got[1][b]) + 31) // 32
        assert np.array_equal(words[b, :used], jwords[b, :used]), b
    assert int(got[1].max()) > 20000    # real blocks, not empty ones


@pytest.mark.parametrize("N", [1024, 4096])
def test_adler_shard_combine_matches_reference(N):
    """Per-rank Adler-32 partials against the reference's shard terms and
    int32-safe combine (block_parallel.py:88-110, 147-156): equal partials
    shard by shard, and their sum gives CPython's Adler-32."""
    import jax.numpy as jnp
    from zlibes_tpu.ops.adler32 import _M, _modsum, _mulmod
    from zlibes_tpu.parallel.block_parallel import _adler_shard_terms

    rng = np.random.default_rng(N)
    n = 7 * N + N // 3
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    nblocks = -(-n // N)
    Bd = -(-nblocks // 3)
    s1_sum = s2_sum = 0
    for shard in range(3):
        lo = shard * Bd
        rows, nv = stage_rows(lambda i: data[i * N : (i + 1) * N], lo,
                              lo + Bd, N)
        s1, s2 = P.block_parallel._adler_shard(
            torch.from_numpy(rows), torch.from_numpy(nv), lo, N, n)
        g_off = jnp.asarray((lo + np.arange(Bd, dtype=np.int32)) * N)
        a_c, b_c, offs = _adler_shard_terms(jnp.asarray(rows),
                                            jnp.asarray(nv), g_off)
        wt = jnp.where(a_c > 0, (n - offs) % _M, 0)
        terms = (_mulmod(wt, a_c) - b_c) % _M
        assert (int(s1), int(s2)) == (int(_modsum(a_c)), int(_modsum(terms)))
        s1_sum += int(s1)
        s2_sum += int(s2)
    assert adler_value(s1_sum % 65521, s2_sum % 65521, n) == \
        pyzlib.adler32(data)
    whole = np.frombuffer(data, np.uint8).astype(np.int64)
    a1, b1 = adler_partials(torch.tensor([whole.sum()]),
                            torch.tensor([(whole * np.arange(n)).sum()]),
                            torch.tensor([0]), n)
    assert adler_value(int(a1), int(b1), n) == pyzlib.adler32(data)
