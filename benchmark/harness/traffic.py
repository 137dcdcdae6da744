"""The one traffic generator: a mix is a JSON file of parameters, and this
module turns it, a configuration and a seed into the run's requests.

Keys of a mix file:

  ``op``      what each request does to the port: ``compress``,
              ``decompress`` or ``range`` (``harness/ops.py``);
  ``files``   the files the mix touches: a key of the configuration,
              ``files`` (its mapping of name to size) or a list of those
              names such as ``read_files``, or a list of names itself;
  ``order``   ``seeded_cycle``: the files in a seeded order, one request
              each, the order repeated until the window closes;
  ``reads``   (``range``) how many reads the seeded list holds; the list
              is cycled if the window outlasts it;
  ``length``  (``range``) ``{"log_uniform": [lo, hi]}`` bytes; the start
              of each read is uniform over all bytes of the files (so a
              larger file gets more reads), and a read that would pass
              the end of its file is cut there.

Every loop is closed: one caller who waits for each result.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .corpus import rng


@dataclass
class FileSpec:
    index: int      # position in the configuration's ``files``: the seed
    name: str       # stream the file's bytes are drawn from
    size: int


def file_specs(config: dict, which) -> list[FileSpec]:
    """The files of ``config`` that ``which`` selects: a key of the
    configuration, or a list of file names."""
    every = list(config["files"].items())
    if isinstance(which, list):
        names = which
    else:
        names = [n for n, _ in every] if which == "files" else config[which]
    pos = {n: i for i, (n, _) in enumerate(every)}
    return [FileSpec(pos[n], n, int(config["files"][n])) for n in names]


class Schedule:
    """The requests of one run, in order: ``item(i)`` is request ``i``."""

    def __init__(self, traffic: dict, files: list[FileSpec], seed: int):
        self.op = traffic["op"]
        self.files = files
        g = rng(seed, 2)
        if traffic.get("order", "seeded_cycle") != "seeded_cycle":
            raise ValueError(f"unknown order {traffic['order']!r}")
        self.order = [int(i) for i in g.permutation(len(files))]
        self.reads = None
        if self.op == "range":
            self.reads = range_reads(traffic, files, rng(seed, 3))

    def item(self, i: int):
        if self.reads is not None:
            f, s, n = self.reads
            k = i % f.size
            return int(f[k]), int(s[k]), int(n[k])
        return self.order[i % len(self.order)]


def range_reads(traffic: dict, files: list[FileSpec], g: np.random.Generator):
    """(file position, start, length) arrays of the seeded read list."""
    lo, hi = traffic["length"]["log_uniform"]
    n = int(traffic["reads"])
    sizes = np.array([f.size for f in files], np.int64)
    ends = np.cumsum(sizes)
    glob = g.integers(0, int(ends[-1]), size=n)
    fpos = np.searchsorted(ends, glob, side="right")
    start = glob - (ends[fpos] - sizes[fpos])
    length = np.exp(g.uniform(np.log(lo), np.log(hi), size=n)).astype(np.int64)
    length = np.maximum(1, np.minimum(length, sizes[fpos] - start))
    return fpos, start, length
