"""What a ``torch.profiler`` trace of the window says: the device's busy
time, each kernel's time, the device time of the program's named spans, and
the idle gaps named by what the host was doing.

Names are the profiler's own (kernel names, ``zlibes.*`` spans, ``aten::``
operators, CUDA runtime calls), so that a later reader can quote them.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

import numpy as np

SPAN_PREFIX = "zlibes."
NAME_CHARS = 160    # a breakdown's names, cut: templated kernel names run long
_COPY = re.compile(r"^(Memcpy|Memset)")


@dataclass
class DeviceOp:
    name: str
    start: float    # microseconds, the profiler's clock
    end: float
    launch: float | None   # when the host made the runtime call


def start_profiler():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


class DeviceTrace:
    """The device records of a traced window of ``window_s`` seconds."""

    def __init__(self, prof, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        # the profiler's raw records: building its FunctionEvent tree takes
        # minutes for a window of some 10^5 launches
        events = prof.profiler.kineto_results.events()
        launched = {}
        host = []
        spans: dict[str, list[tuple[float, float]]] = {}
        dev = []
        for e in events:
            name = e.name()
            s = e.start_ns() / 1e3
            t = s + e.duration_ns() / 1e3
            if e.device_type() == DeviceType.CPU:
                if name.startswith("cu"):
                    launched[e.correlation_id()] = s
                if name.startswith(SPAN_PREFIX):
                    spans.setdefault(name, []).append((s, t))
                host.append((s, t, name))
            elif not (name.startswith(SPAN_PREFIX) or e.is_user_annotation()):
                dev.append((name, s, t, e.correlation_id()))
        self.ops = [DeviceOp(n, s, e, launched.get(i)) for n, s, e, i in dev]
        self.spans = {k: sorted(v) for k, v in spans.items()}
        host.sort()
        self._host = host
        self._host_starts = [h[0] for h in host]
        ends = sorted((h[1], h[2]) for h in host)
        self._host_ends = [e for e, _ in ends]
        self._host_end_names = [n for _, n in ends]
        self.busy_intervals = _union([(o.start, o.end) for o in self.ops])
        self.busy_s = sum(e - s for s, e in self.busy_intervals) / 1e6

    # -- kernels
    def time_s(self, pattern: str, kernels_only: bool = False) -> float:
        """Seconds of the device records whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(o.end - o.start for o in self.ops if rx.search(o.name)
                   and not (kernels_only and _COPY.match(o.name))) / 1e6

    def kernel_s(self) -> float:
        return sum(o.end - o.start for o in self.ops
                   if not _COPY.match(o.name)) / 1e6

    def count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for o in self.ops if rx.search(o.name))

    def span_device_s(self, name: str) -> float | None:
        """Device seconds of the records whose runtime call the host made
        inside a span ``name`` (None if the trace holds no such span)."""
        ranges = self.spans.get(name)
        if not ranges:
            return None
        starts = [r[0] for r in ranges]
        total = 0.0
        for o in self.ops:
            if o.launch is None:
                continue
            k = bisect.bisect_right(starts, o.launch) - 1
            if k >= 0 and o.launch <= ranges[k][1]:
                total += o.end - o.start
        return total / 1e6

    # -- breakdown
    def top_ops(self, n: int = 10) -> list[list]:
        per: dict[str, float] = {}
        for o in self.ops:
            per[o.name] = per.get(o.name, 0.0) + (o.end - o.start) / 1e6
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:NAME_CHARS], v] for k, v in top]

    def _host_doing(self, t: float) -> str:
        """The innermost host operation under way at ``t``, or the one that
        last ended before it."""
        k = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(k, max(-1, k - 256), -1):
            s, e, name = self._host[j]
            if e >= t:
                return name
        k = bisect.bisect_right(self._host_ends, t) - 1
        if k >= 0:
            return f"host after {self._host_end_names[k]}"
        return "host"

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle time between device records, summed by what the host was
        doing at each gap's middle; the ``n`` largest sums."""
        per: dict[str, float] = {}
        iv = self.busy_intervals
        for (_, e0), (s1, _) in zip(iv, iv[1:]):
            name = self._host_doing((e0 + s1) / 2)
            per[name] = per.get(name, 0.0) + (s1 - e0) / 1e6
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:NAME_CHARS], v] for k, v in top]


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    if not iv:
        return []
    a = np.array(sorted(iv))
    out = []
    cs, ce = a[0]
    for s, e in a[1:]:
        if s > ce:
            out.append((float(cs), float(ce)))
            cs, ce = s, e
        elif e > ce:
            ce = e
    out.append((float(cs), float(ce)))
    return out
