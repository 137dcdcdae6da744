"""``block_tables`` on the CPU: its plain route, the host planner, against
the host functions it composes (``package_merge_np``, ``_dynamic_header``,
``_payload_bits``, ``_encode_tables``), block by block, on hand-made
dispatches (``block_tables_cases``).  The kernel is held to the same
cases on a card in ``test_torch_cuda.py``.  Imports no JAX.
"""
import pytest
import torch

import block_tables_cases as cases
from zlibes_tpu_torch.ops import block_tables as bt
from zlibes_tpu_torch.ops import turbo_kernel as tk


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_plain_route_equals_the_host_functions(name):
    args = cases.case(name)
    want = cases.expected(*args)
    tk.LAUNCHES.clear()
    got = bt.block_tables(*args)
    assert not tk.LAUNCHES
    cases.check(got, want, args[0].shape[0])
    if name in cases.WANT_BTYPE:
        assert [w[0] for w in want] == cases.WANT_BTYPE[name]
    # the outputs are pack_payload's arguments as it takes them
    assert [t.dtype for t in got] == [torch.int64] * 5 + [torch.bool,
                                                          torch.int64]


def test_wrapper_checks_its_arguments():
    ll, d, nv, nblocks, final = cases.case("random")
    with pytest.raises(ValueError, match="dtype"):
        bt.block_tables(ll.int(), d, nv, nblocks, final)
    with pytest.raises(ValueError, match="shape"):
        bt.block_tables(ll, d[:, :30].contiguous(), nv, nblocks, final)
    with pytest.raises(ValueError, match="do not fit"):
        bt.block_tables(ll, d, nv, nblocks + 1, final)
    with pytest.raises(ValueError, match="do not fit"):
        bt.block_tables(ll, d, nv, nblocks, nblocks)
