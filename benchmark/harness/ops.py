"""What one request of a traffic mix does to the port, what the harness
keeps of it, and how the kept results are judged after the window.

An op has ``setup()`` (work its traffic needs before the window, such as
the streams a read mix reads), ``warm()``, ``call(item)`` (the timed
request), ``record(...)``, ``after_window()`` (untimed work an end-to-end
metric needs) and ``judge()`` (the counts that decide ``correct``, each
with its limit).  ``call`` is the timed path; a fault or a control replaces
it (``harness/substitutes.py``).  A traffic mix whose ``op`` is none of
these finds it in ``ops/<op>.py`` under the benchmark's folder (a class
``Op``, as those here).
"""
from __future__ import annotations

import hashlib
import statistics
import sys

import numpy as np
import torch

from reference import judge

from .corpus import rng


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Op:
    kind = ""

    def __init__(self, encoder, files, datas, device, seed: int):
        self.encoder = encoder
        self.files = files          # [FileSpec]
        self.datas = datas          # bytes of each file, in ``files`` order
        self.device = device
        self.seed = seed
        self.attempted = 0
        self.failed = 0
        self.calls: list[tuple] = []      # (item, t0, t1, work bytes)

    def setup(self):
        pass

    def warm(self):
        pass

    def record(self, item, result, t0: float, t1: float):
        pass

    def after_window(self):
        pass

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def work(self) -> dict:
        return {}


class Compress(Op):
    """``encode(file)``: the stream's bytes and index on the host, as the
    API returns them."""
    kind = "compress"

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.first: dict[int, tuple] = {}     # file -> (stream, index)
        self.kept: list[tuple] = []           # (file, stream, index)

    def warm(self):
        small = min(range(len(self.files)), key=lambda i: self.files[i].size)
        self.call(small)
        self.sync()

    def call(self, item):
        return self.encoder.encode(self.datas[item])

    def record(self, item, result, t0, t1):
        comp, index = result
        self.calls.append((item, t0, t1, self.files[item].size))
        self.kept.append((item, comp, index))
        self.first.setdefault(item, (comp, index))

    def after_window(self):
        # a file the window never reached is compressed once, untimed, so
        # that the ratio covers every file whatever the speed
        for i in range(len(self.files)):
            if i not in self.first:
                comp, index = self.call(i)
                self.first[i] = (comp, index)
                self.kept.append((i, comp, index))

    def stored_ratio(self) -> float:
        comp = sum(len(self.first[i][0]) for i in range(len(self.files)))
        return comp / sum(f.size for f in self.files)

    def digests(self) -> list[tuple[int, str]]:
        return [(i, hashlib.sha256(c).hexdigest()) for i, c, _ in self.kept]

    def judge(self, index_kind: str | None) -> dict:
        from .codec import index_arrays

        seen = {}
        for i, comp, index in self.kept:
            key = (i, hashlib.sha256(comp).digest())
            if key not in seen:
                seen[key] = (comp, index)
        bad_s = bad_b = bad_a = 0
        g = rng(self.seed, 4)
        for (i, _), (comp, index) in seen.items():
            data = self.datas[i]
            bad_s += judge.stream_faults(comp, data)
            if index_kind is None:
                continue
            if index is None:
                bad_b += 1
                continue
            ix = index if isinstance(index, dict) else index_arrays(index)
            # an index that does not fit its stream or data is a fault
            try:
                bad_b += judge.block_faults(comp, data, ix)
            except (ValueError, IndexError) as exc:
                bad_b += 1
                log(f"blocks of file {i}: {exc!r}")
            if index_kind == "wide":
                try:
                    bad_a += (judge.anchor_faults(comp, data, ix, g)
                              if ix["wide"] else 1)
                except (ValueError, IndexError) as exc:
                    bad_a += 1
                    log(f"anchors of file {i}: {exc!r}")
        checks = {"bad_streams": bad_s}
        if index_kind is not None:
            checks["bad_blocks"] = bad_b
        if index_kind == "wide":
            checks["bad_anchors"] = bad_a
        checks["distinct_streams"] = len(seen)
        return checks

    def work(self) -> dict:
        return {"bytes_in": sum(c[3] for c in self.calls),
                "stage_s": dict(self.encoder.stats.stage_s)}


class _ReadOp(Op):
    """A mix that reads streams the set-up wrote with the port's encoder."""

    def setup(self):
        self.streams = [self.encoder.encode(d) for d in self.datas]
        self.sync()

    def judge_streams(self) -> int:
        return sum(judge.stream_faults(c, d)
                   for (c, _), d in zip(self.streams, self.datas))


class Decompress(_ReadOp):
    """``inflate_to_device(stream, index)``: the bytes stay on the card."""
    kind = "decompress"
    SAMPLE_EVERY = 16

    def setup(self):
        super().setup()
        self.pick = rng(self.seed, 5)
        self.kept: list[tuple] = []
        self.seen: set[int] = set()

    def warm(self):
        for i in range(len(self.files)):
            self.call(i)
        self.sync()

    def call(self, item):
        comp, index = self.streams[item]
        from .codec import inflate_to_device

        out = inflate_to_device(comp, index, self.device)
        self.sync()
        return out

    def record(self, item, result, t0, t1):
        self.calls.append((item, t0, t1, int(result.numel())))
        # the first output of each file and a seeded sample of the others
        # are judged after the window
        if item not in self.seen or self.pick.integers(self.SAMPLE_EVERY) == 0:
            self.seen.add(item)
            self.kept.append((item, result))

    def judge(self, index_kind=None) -> dict:
        bad = 0
        for item, out in self.kept:
            got = out.cpu().numpy().tobytes()
            bad += int(got != self.datas[item])
        return {"bad_outputs": bad, "bad_streams": self.judge_streams(),
                "judged_outputs": len(self.kept)}

    def work(self) -> dict:
        return {"bytes_out": sum(c[3] for c in self.calls)}


class Range(_ReadOp):
    """``inflate_range(stream, index, start, length)``: bytes on the host."""
    kind = "range"

    def setup(self):
        super().setup()
        self.kept: list[tuple] = []

    def warm(self):
        # one read of each file at the mix's longest length, and one that
        # crosses a block boundary, outside the seeded list
        for i, f in enumerate(self.files):
            n = min(f.size, 1 << 18)
            self.call((i, 0, n))
            self.call((i, max(0, f.size // 2 - n // 2), n))
        self.sync()

    def call(self, item):
        i, start, length = item
        comp, index = self.streams[i]
        from .codec import inflate_range

        return inflate_range(comp, index, start, length, self.device)

    def record(self, item, result, t0, t1):
        self.calls.append((item, t0, t1, item[2]))
        self.kept.append((item, result))

    def latencies_ms(self) -> list[float]:
        return [(t1 - t0) * 1e3 for _, t0, t1, _ in self.calls]

    def judge(self, index_kind=None) -> dict:
        bad = sum(judge.range_faults(got, self.datas[i], s, n)
                  for (i, s, n), got in self.kept)
        return {"bad_reads": bad, "bad_streams": self.judge_streams(),
                "judged_reads": len(self.kept)}

    def work(self) -> dict:
        lat = self.latencies_ms()
        return {"reads": len(lat),
                "p50_ms": statistics.median(lat) if lat else None,
                "p95_ms": float(np.percentile(lat, 95)) if lat else None}


OPS = {cls.kind: cls for cls in (Compress, Decompress, Range)}
