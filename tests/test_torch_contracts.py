"""The contract cases of ``test_torch_contract_cases.py`` through the JAX
package's Pallas kernels (interpret mode on the CPU) and through the port's
plain versions: the same inputs, made with numpy, must give the same bytes
and tokens, exactly (all integers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zlibes_tpu.codec import deflate_pipeline as dp
from zlibes_tpu.ops import wide_kernel as jwk

from zlibes_tpu_torch.codec import deflate_pipeline as tdp
from zlibes_tpu_torch.ops import wide_kernel as wk
import test_torch_contract_cases as cases

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def resolved():
    toks, starts, want = cases.resolve_inputs()
    jax_rows = np.asarray(jwk.resolve_wide(jnp.asarray(toks),
                                           jnp.asarray(starts),
                                           NSUBB=cases.NSUBB))
    rows = wk.resolve_wide(torch.from_numpy(toks),
                           torch.from_numpy(starts)).numpy()
    return jax_rows, rows, want


@pytest.mark.parametrize("case", cases.RESOLVE_CASES)
def test_resolve_wide_case_matches_reference(resolved, case):
    jax_rows, rows, want = resolved
    i = cases.RESOLVE_CASES.index(case)
    assert np.array_equal(jax_rows[i], want[i])
    assert np.array_equal(rows[i], jax_rows[i])


@pytest.fixture(scope="module", params=[True, False], ids=["lazy", "greedy"])
def selected(request):
    lazy = request.param
    blk, matches, nv = cases.select_dispatch()
    jtv, jtd, jcnt = (np.asarray(x) for x in dp._select_turbo_glue(
        jnp.asarray(blk), jnp.asarray(matches), jnp.asarray(nv), N=cases.BS,
        SEG_SIZE=512, lazy=lazy, split_far=True))
    tv, td, cnt = tdp.select_glue(torch.from_numpy(blk),
                                  torch.from_numpy(matches),
                                  torch.from_numpy(nv), cases.BS, lazy)
    return lazy, (jtv, jtd, jcnt), (tv.numpy(), td.numpy(), cnt.numpy())


@pytest.mark.parametrize("case", cases.SELECT_CASES)
def test_select_turbo_case_matches_reference(selected, case):
    lazy, (jtv, jtd, jcnt), (tv, td, cnt) = selected
    lane = cases.SELECT_LANE[case]
    blk, _, _ = cases.select_dispatch()
    count, _ = cases.select_expected(case, lazy, blk)
    assert int(jcnt[lane]) == int(cnt[lane]) == count
    assert np.array_equal(tv[lane, :count], jtv[lane, :count])
    assert np.array_equal(td[lane, :count], jtd[lane, :count])
    assert not tv[lane, count:].any() and not td[lane, count:].any()


def test_select_turbo_whole_dispatch_matches_reference(selected):
    _, (jtv, jtd, jcnt), (tv, td, cnt) = selected
    assert np.array_equal(cnt, jcnt)
    valid = np.arange(512)[None, :] < jcnt[:, None]
    assert np.array_equal(tv[valid], jtv[valid])
    assert np.array_equal(td[valid], jtd[valid])


# ---------------------------------------------------------------------------
# decode_tokens and resolve_global: the JAX XLA programs against the port's
# plain versions on the walk and span cases

def _jax_walk_decode(case: str):
    """The JAX ``decode_tokens`` in the form ``run_walk_case`` calls: the
    case's rows as flat tables, tokens repacked into the port's (T, B)
    layout with their starts."""
    from test_torch_generic import _flat_tables, _jax_stream
    from zlibes_tpu.ops import inflate_kernel as jik

    ll_tab, d_tab = _flat_tables(cases._walk_case_spec(case)[0])

    def decode(words, lt, dt, rows, bit0, endb, active, T):
        w32, bts = _jax_stream(words)
        val, dist, count, bitpos, still, err = (
            np.asarray(x) for x in jik.decode_tokens(
                w32, bts, ll_tab, d_tab, rows, np.asarray(bit0, np.int32),
                endb.astype(np.int32), np.asarray(active), T=T, M=15, D=15))
        emitted = np.arange(T)[None, :] < count[:, None]
        tokens = np.where(dist > 0, val | (dist << 9) | (1 << 25), val)
        lens = np.where(dist > 0, val, 1) * emitted
        starts = np.cumsum(lens, axis=1) - lens
        return (np.where(emitted, tokens, 0).T, starts.T, count,
                bitpos.astype(np.int64), still, err)

    return decode


@pytest.mark.parametrize("case", cases.WALK_CASES)
def test_decode_tokens_walk_case_matches_reference(case):
    """Call for call: counts, end bits, flags, and the emitted tokens and
    starts of the plain version equal the JAX ones (each also holds the
    case's tokens, ``run_walk_case``)."""
    got = cases.run_walk_case(case, cases._plain_walk)
    want = cases.run_walk_case(case, _jax_walk_decode(case))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        emitted = np.arange(g[0].shape[0])[:, None] < w[2][None, :]
        for a, b in zip(g[2:], w[2:]):
            assert np.array_equal(a, b)
        assert np.array_equal(g[0][emitted], w[0][emitted])
        assert np.array_equal(g[1][emitted], w[1][emitted])


@pytest.mark.parametrize("case", cases.RESOLVE_SPAN_CASES)
def test_resolve_global_span_case_matches_reference(case):
    from test_torch_generic import both_resolves

    (tokens, starts, count, out_base, total, prefix), want = \
        cases.span_case(case)
    O = 1 << (total - 1).bit_length()
    out, err = both_resolves(tokens, starts, count, out_base, total, prefix,
                             O)
    assert not err and np.array_equal(out, want)


# ---------------------------------------------------------------------------
# select_tokens: the JAX XLA program against the port's plain version on the
# chain cases

@pytest.mark.parametrize("case", cases.SELECT_CHAIN_CASES)
def test_select_tokens_chain_case_matches_reference(case):
    """Counts, and tokens in [0, count), equal the JAX ``select_tokens``'
    exactly (the port also writes zeros past each count)."""
    from zlibes_tpu.ops import lz77 as jlz

    data, matches, nv, kw = cases.select_chain_case(case)
    jtv, jtd, jcnt = (np.asarray(x) for x in jlz.select_tokens(
        jnp.asarray(data), jnp.asarray(matches), jnp.asarray(nv), **kw))
    tv, td, cnt = cases.select_chain_plain(case)
    assert np.array_equal(cnt, jcnt)
    valid = np.arange(tv.shape[1])[None, :] < jcnt[:, None]
    assert np.array_equal(tv[valid], jtv[valid])
    assert np.array_equal(td[valid], jtd[valid])
