"""Each kernel's contract bytes (``benchmark/roofline/``) at the bench
corpus's shapes, against the figures ``chip_smoke.py`` printed from the
run's tensors: within a few percent."""
import pytest

from harness.codec import index_arrays
from roofline import decode_turbo, peaks, resolve_turbo, select_tokens

from benchlib import ROOT

GOLDEN = ROOT / "tests" / "golden"


def near(got, want, rel=0.03):
    return abs(got - want) <= rel * want


def test_select_tokens_a_full_level6_dispatch():
    # 16 blocks of 128 KiB, 4 KiB lanes: chip_smoke.py read 27.3 MB
    got = select_tokens.contract_bytes(16 * 131072)
    assert got == 13 * 16 * 131072 + 4 * 16 + 4 * 16 * 32
    assert near(got, 27.3e6)
    # a short last dispatch fills all its rows' slots, reads only its bytes
    assert select_tokens.contract_bytes(131072) == (
        5 * 131072 + 4 * 16 + 8 * 16 * 131072 + 4 * 16 * 32)


def test_resolve_turbo_the_bench_corpus():
    got = resolve_turbo.contract_bytes(3_843_200)
    assert got == 939 * (2 * 16 * 384 * 4 + 4096)
    assert near(got, 50.0e6)


def test_decode_turbo_the_bench_corpus():
    import zlibes_tpu_torch as zt

    comp = (GOLDEN / "turbo_bench.zz").read_bytes()
    ix = index_arrays(zt.StreamIndex.load(GOLDEN / "turbo_bench.idx.npz"))
    lanes, tokens = decode_turbo.lanes_and_tokens(comp, ix)
    assert lanes == 15_014
    got = decode_turbo.contract_bytes(len(comp), lanes, tokens)
    assert near(got, 7.6e6)


def test_a_share_needs_a_time():
    assert peaks.share_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert peaks.share_pct(1, 0.0) is None
