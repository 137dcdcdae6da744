"""Host time of the program's named spans (``zlibes.*``) in a traced window,
on the profiler's clock: the arithmetic the span metrics share.

A span's host time is the union of its entries' intervals, so that a span
entered inside another of its name is counted once.  Its self time leaves
out the time of the named children that lie inside it.  Both are None when
the trace holds no span of the name (a program without it).
"""
from __future__ import annotations


def _union(iv) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _length(iv) -> float:
    return sum(e - s for s, e in iv)


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_s(trace, name: str) -> float | None:
    """Seconds the host spent inside spans ``name`` over the window."""
    iv = trace.spans.get(name) if trace is not None else None
    if not iv:
        return None
    return _length(_union(iv)) / 1e6


def self_s(trace, name: str, children: tuple[str, ...]) -> float | None:
    """Seconds inside spans ``name`` outside the spans ``children``."""
    iv = trace.spans.get(name) if trace is not None else None
    if not iv:
        return None
    own = _union(iv)
    kids = _union([x for c in children for x in trace.spans.get(c, [])])
    return (_length(own) - _overlap(own, kids)) / 1e6


def per_mib(seconds: float | None, nbytes: int) -> float | None:
    """Milliseconds a MiB of ``nbytes``, or None."""
    if seconds is None or not nbytes:
        return None
    return seconds * 1e3 / (nbytes / 2**20)


def per_read(seconds: float | None, reads: int) -> float | None:
    """Milliseconds a read, or None."""
    if seconds is None or not reads:
        return None
    return seconds * 1e3 / reads
