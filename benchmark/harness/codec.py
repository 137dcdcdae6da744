"""The program under test, ``zlibes_tpu_torch``, bound to a configuration's
``encoder`` settings.  This is the only module of the harness that imports
the port.

``encoder.api`` names the entry:

  ``deflate_indexed``  ``deflate(data, with_index=True)`` of the port's
                       pipeline at the default config (what
                       ``zlibes_tpu_torch.deflate_indexed`` calls), with a
                       ``CodecStats`` passed in;
  ``turbo_indexed``    the same at ``CodecConfig.turbo()``;
  ``parallel_deflate`` ``zlibes_tpu_torch.parallel.parallel_deflate(data,
                       mesh, **params)`` over the run's process group;
  any other name       ``apis/<name>.py`` under the benchmark's folder, whose
                       ``make(encoder_settings, device, mesh)`` returns
                       ``encode(data) -> (stream, index or None)``.

``encoder.codec_config`` (optional) replaces fields of the entry's
``CodecConfig``, and ``encoder.params`` are keyword arguments of
``parallel_deflate``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import zlibes_tpu_torch as zt
from zlibes_tpu_torch.codec import deflate_pipeline


def _codec_config(enc: dict):
    api = enc["api"]
    base = zt.CodecConfig.turbo() if api == "turbo_indexed" else None
    fields = enc.get("codec_config") or {}
    if fields:
        base = dataclasses.replace(base or zt.CodecConfig(), **fields)
    return base


class Encoder:
    """``encode(data) -> (stream bytes, index or None)`` for one config."""

    def __init__(self, config: dict, device: torch.device, mesh=None,
                 bench_dir=None):
        self.enc = config["encoder"]
        self.api = self.enc["api"]
        self.device = device
        self.mesh = mesh
        self.stats = zt.CodecStats()
        if self.api in ("deflate_indexed", "turbo_indexed"):
            self.cfg = _codec_config(self.enc)
        elif self.api == "parallel_deflate":
            from zlibes_tpu_torch.parallel import parallel_deflate

            self._pdeflate = parallel_deflate
            self.params = dict(self.enc.get("params") or {})
        else:
            from .spec import plugin

            self._encode = plugin(bench_dir, "apis", self.api).make(
                self.enc, device, mesh)

    def encode(self, data: bytes):
        if hasattr(self, "_encode"):
            return self._encode(data)
        if self.api == "parallel_deflate":
            out = self._pdeflate(data, self.mesh, **self.params)
            return (out if isinstance(out, tuple) else (out, None))
        return deflate_pipeline.deflate(data, with_index=True, config=self.cfg,
                                        stats=self.stats, device=self.device)


def inflate_to_device(comp: bytes, index, device: torch.device):
    """The decoded bytes as one uint8 tensor on ``device``."""
    spans = zt.inflate_to_device(comp, index, device=device)
    (out, off, n), = spans
    if off != 0:
        raise ValueError(f"inflate_to_device returned a span at {off}")
    return out[:n]


def inflate_range(comp: bytes, index, start: int, length: int,
                  device: torch.device) -> bytes:
    return zt.inflate_range(comp, index, start, length, device=device)


def index_arrays(index) -> dict:
    """A ``StreamIndex`` as the plain arrays the reference judges."""
    rows = np.array([[b.btype, int(b.bfinal), b.start_bit,
                      b.payload_start_bit, b.end_bit, b.out_start, b.out_len]
                     for b in index.blocks], np.int64).reshape(-1, 7)
    return {"blocks": rows,
            "bit": np.asarray(index.anchor_bit, np.int64),
            "out": np.asarray(index.anchor_out, np.int64),
            "block": np.asarray(index.anchor_block, np.int64),
            "turbo": bool(getattr(index, "turbo", False)),
            "wide": bool(getattr(index, "wide", False))}


def make_mesh(device: torch.device):
    from zlibes_tpu_torch.parallel import make_mesh as mk

    return mk(device=device.type)
