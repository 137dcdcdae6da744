"""The seeded data and traffic: the same seed gives the same requests,
another seed other ones."""
import numpy as np

from harness import corpus
from harness.traffic import FileSpec, Schedule, range_reads

from benchlib import SEED


def test_files_are_deterministic_and_differ_across_seeds():
    raw = corpus.raw_corpus()
    a = corpus.make_file(raw, 300_000, SEED, 3)
    assert len(a) == 300_000
    assert a == corpus.make_file(raw, 300_000, SEED, 3)
    assert a != corpus.make_file(raw, 300_000, SEED + 1, 3)
    assert a != corpus.make_file(raw, 300_000, SEED, 4)
    # a negative or 64-bit seed is a seed too
    assert corpus.make_file(raw, 1000, -5, 0) == corpus.make_file(
        raw, 1000, -5, 0)
    assert len(corpus.make_file(raw, 1000, 2**40 + 3, 0)) == 1000


def test_files_are_slices_of_the_corpus():
    raw = corpus.raw_corpus().tobytes()
    ring = raw + raw
    f = corpus.make_file(np.frombuffer(raw, np.uint8), 200_000, SEED, 0)
    # every slice is at least 64 KiB, so its first 64 KiB lie in the ring
    assert f[:corpus.SLICE_MIN] in ring


def test_schedules_are_deterministic_and_differ_across_seeds():
    files = [FileSpec(i, n, s) for i, (n, s) in
             enumerate([("a", 10), ("b", 20), ("c", 30), ("d", 40)])]
    t = {"op": "compress", "order": "seeded_cycle"}
    s1, s2 = Schedule(t, files, SEED), Schedule(t, files, SEED)
    assert [s1.item(i) for i in range(12)] == [s2.item(i) for i in range(12)]
    assert sorted(s1.order) == [0, 1, 2, 3]
    assert s1.item(0) == s1.item(4)
    orders = {tuple(Schedule(t, files, SEED + k).order) for k in range(8)}
    assert len(orders) > 1


def test_range_reads_lie_inside_their_files():
    files = [FileSpec(0, "a", 5_000_000), FileSpec(1, "b", 300_000)]
    t = {"length": {"log_uniform": [1024, 262144]}, "reads": 20000}
    f, s, n = range_reads(t, files, corpus.rng(SEED, 3))
    sizes = np.array([5_000_000, 300_000])
    assert (s >= 0).all() and (n >= 1).all() and (s + n <= sizes[f]).all()
    assert n.max() <= 262144
    # starts are uniform over all bytes: the larger file gets most reads
    assert 0.9 < (f == 0).mean() < 0.97
    f2, s2, n2 = range_reads(t, files, corpus.rng(SEED, 3))
    assert (f == f2).all() and (s == s2).all() and (n == n2).all()
