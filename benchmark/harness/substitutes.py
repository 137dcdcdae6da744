"""Replacements of an op's timed path, for the checks of the comparison:
the control (the reference in the program's place, ``reference/controls.py``)
and the faults the comparison has to catch.  The benchmark's own runs use
neither; ``control.py`` and the tests do.

Faults, each planted where the answer is produced:

  ``flip``        one byte of the answer altered;
  ``half``        half of the answer left out (a stream cut, the second
                  half of an output zeroed, a read cut short);
  ``stale``       the previous request's answer returned again, as by a
                  step that leaves its state unchanged;
  ``no_exchange`` (block parallelism) the exchange between ranks left out:
                  each rank's collectives see its own part alone.
"""
from __future__ import annotations

import zlib

import torch

from reference import controls

FAULTS = ("flip", "half", "stale", "no_exchange")


def _flip(x):
    if isinstance(x, torch.Tensor):
        x[x.numel() // 2] ^= 1
        return x
    b = bytearray(x)
    b[len(b) // 2] ^= 1
    return bytes(b)


def _half(x):
    if isinstance(x, torch.Tensor):
        x[x.numel() // 2:] = 0
        return x
    return x[:len(x) // 2]


def _answer(op, result, fn):
    if op.kind == "compress":
        comp, index = result
        return fn(comp), index
    return fn(result)


def plant_fault(op, fault: str) -> None:
    """Break ``op``'s timed path with ``fault``."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    call = op.call
    if fault == "no_exchange":
        from zlibes_tpu_torch.parallel import block_parallel as bp

        bp._all_reduce = lambda mesh, t, *a, **k: t.clone()
        bp._all_gather = lambda mesh, t: [t.clone() for _ in range(mesh.size)]
        return
    if fault == "stale":
        last = []

        def stale(item):
            out = call(item)
            if op.kind == "decompress":
                out = out.clone()
            prev = last[0] if last else out
            last[:] = [out]
            return prev
        op.call = stale
        return
    fn = _flip if fault == "flip" else _half
    op.call = lambda item: _answer(op, call(item), fn)


def plant_control(op, world: int = 1) -> str:
    """Put the cell's control in place of ``op``'s timed path; returns its
    name."""
    if op.kind == "compress":
        if op.encoder.api == "parallel_deflate":
            block = int((op.encoder.params or {}).get("block_size", 32768))
            op.call = lambda item: (controls.adler_share(
                op.datas[item], world, block), None)
            return "adler_share"
        op.call = lambda item: controls.wide_index(op.datas[item])
        return "wide_index"
    if op.kind == "decompress":
        def row_pad(item):
            out = controls.row_pad(op.streams[item][0])
            return torch.frombuffer(bytearray(out), dtype=torch.uint8).to(
                op.device)
        op.call = row_pad
        return "row_pad"
    if op.kind == "range":
        whole = {}

        def grain(item):
            i, start, length = item
            if i not in whole:
                whole[i] = zlib.decompress(op.streams[i][0])
            return controls.grain(whole[i], start, length)
        op.call = grain
        return "grain"
    raise ValueError(f"no control for op {op.kind!r}")
