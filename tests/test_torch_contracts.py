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
