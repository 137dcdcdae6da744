"""Generate the committed bench fixtures (streams + sidecar indexes).

The machine that runs the PyTorch port (``zlibes_tpu_torch``) on a GPU has
no JAX, so the bench-sized streams and digests the port is held against
there are made here, once, by the JAX package's encoder on the CPU backend
(and, where that encoder is wrong, by the port's CPU run):

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py [--parallel | --shared]

Writes, from the bench corpus:

  * ``tests/golden/turbo_bench.{zz,idx.npz}`` — ``CodecConfig.turbo()``;
  * ``tests/golden/wide_bench.{zz,idx.npz}`` — ``CodecConfig.from_level(6)``
    (zlib's default level: the default-profile stream with wide anchors);
  * ``tests/golden/parallel_bench.json`` — the length and SHA-256 of what
    the JAX package's ``parallel_deflate`` writes on an 8-device CPU mesh
    in three modes (dynamic, ``dynamic=False``, ``turbo=True,
    with_index=True``, each at its default ``block_size``) for the whole
    corpus, and at ``block_size=16384`` for the first 131,072 bytes of
    ``tests/golden/raw.bin``, with the SHA-256 of the turbo index's arrays
    (``tests/torch_parallel_worker.py: index_sha256``).  ``--parallel``
    writes this file alone (~40 s);
  * ``tests/golden/shared_bench.json`` — for each shared-tables config of
    ``tests/shared_tables_cases.py`` (``shared_full``, ``shared_turbo15``,
    ``shared_seg1024``), the length and SHA-256 of the stream that
    ``deflate(data, config=...)`` writes at the default block size, and of
    its index's arrays, for the corpus and for the buffers of 64 KiB that
    take coded tokens past 32 bits (``skewed_data``, ``far_copy_data``).
    Where every coded token fits 32 bits (the port's ``encode_fields``
    says so) the digests are the JAX package's, and the port's CPU run
    must equal it; elsewhere the reference's 32-bit field writes wrong
    bytes, and the digests are the port's CPU run's, held against CPython
    (``"source"`` says which).  ``--shared`` writes this file alone
    (~90 s).
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import zlib as pyzlib
from pathlib import Path

# the reference's parallel_deflate runs on an 8-device virtual CPU mesh (as
# in tests/conftest.py); XLA reads the flag once, before its first client
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from tools.make_bench_fixture import bench_data  # noqa: E402
from torch_parallel_worker import (  # noqa: E402
    PREFIX, PREFIX_MODES, RAW, index_sha256)

# the full-corpus modes of parallel_bench.json: parallel_deflate's defaults
# (block_size 32768) but for the mode's own arguments
FULL_MODES = {
    "dynamic": {},
    "fixed": dict(dynamic=False),
    "turbo": dict(turbo=True, with_index=True),
}


def parallel_digests() -> dict:
    """What the reference's parallel_deflate writes, mode by mode."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from zlibes_tpu.parallel import make_mesh, parallel_deflate

    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    out = {"mesh": 8}
    for what, data, modes in (("corpus", bench_data(), FULL_MODES),
                              ("prefix", RAW[:PREFIX], PREFIX_MODES)):
        entry = {"bytes_in": len(data)}
        for mode, kw in modes.items():
            res = parallel_deflate(data, mesh, **kw)
            comp, index = res if isinstance(res, tuple) else (res, None)
            assert pyzlib.decompress(comp) == data
            rec = dict(args=kw, length=len(comp),
                       sha256=hashlib.sha256(comp).hexdigest())
            if index is not None:
                rec["index"] = dict(
                    sha256=index_sha256(index), blocks=len(index.blocks),
                    anchors=int(index.anchor_bit.size),
                    max_tokens=int(index.max_tokens))
            entry[mode] = rec
            print(f"parallel_deflate {what} {mode}: {len(data)} B -> "
                  f"{len(comp)} B")
        out[what] = entry
    return out


def shared_digests() -> dict:
    """The digests of ``shared_bench.json``, config by config."""
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    from zlibes_tpu.codec import deflate_pipeline as jdp
    from zlibes_tpu.config import CodecConfig as JaxCodecConfig

    from shared_tables_cases import (SHARED_CONFIGS, far_copy_data,
                                     skewed_data, widest_token)
    from zlibes_tpu_torch.codec import deflate_pipeline as tdp

    inputs = {"corpus": bench_data(), "skewed": skewed_data(),
              "far_copies": far_copy_data()}
    out = {}
    for name, cfg in SHARED_CONFIGS.items():
        entry = {"config": {f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)}}
        # two blocks a dispatch keep the CPU runs small; the bytes do not
        # depend on it
        cfg = dataclasses.replace(cfg, blocks_per_dispatch=2)
        for what, data in inputs.items():
            with widest_token() as widest:
                comp, index = tdp.deflate(data, with_index=True, config=cfg,
                                          device="cpu")
            assert pyzlib.decompress(comp) == data
            source = "port"
            if widest[0] <= 32:
                jcfg = JaxCodecConfig(**{f.name: getattr(cfg, f.name)
                                         for f in dataclasses.fields(cfg)})
                jcomp, jindex = jdp.deflate(data, with_index=True,
                                            config=jcfg)
                assert jcomp == comp and \
                    index_sha256(jindex) == index_sha256(index), (name, what)
                source = "zlibes_tpu"
            entry[what] = dict(
                bytes_in=len(data), length=len(comp),
                sha256=hashlib.sha256(comp).hexdigest(), source=source,
                widest_token_bits=widest[0],
                index=dict(sha256=index_sha256(index),
                           blocks=len(index.blocks),
                           anchors=int(index.anchor_bit.size),
                           max_tokens=int(index.max_tokens)))
            print(f"{name} {what}: {len(data)} B -> {len(comp)} B, widest "
                  f"token {widest[0]} bits, digests from {source}")
        out[name] = entry
    return out


def main() -> None:
    if "--shared" in sys.argv[1:]:
        path = ROOT / "tests" / "golden" / "shared_bench.json"
        path.write_text(json.dumps(shared_digests(), indent=1) + "\n")
        return
    path = ROOT / "tests" / "golden" / "parallel_bench.json"
    path.write_text(json.dumps(parallel_digests(), indent=1) + "\n")
    if "--parallel" in sys.argv[1:]:
        return
    from zlibes_tpu.codec import deflate_pipeline as dp
    from zlibes_tpu.config import CodecConfig

    data = bench_data()
    out_dir = ROOT / "tests" / "golden"
    for name, config, flag in (("turbo_bench", CodecConfig.turbo(), "turbo"),
                               ("wide_bench", CodecConfig.from_level(6),
                                "wide")):
        comp, index = dp.deflate(data, with_index=True, config=config)
        assert getattr(index, flag)
        assert pyzlib.decompress(comp) == data
        stream = out_dir / f"{name}.zz"
        idx = out_dir / f"{name}.idx.npz"
        stream.write_bytes(comp)
        index.save(idx)
        print(f"{name}: corpus {len(data)} B -> stream {len(comp)} B "
              f"(ratio {len(comp) / len(data):.4f}), {len(index.blocks)} "
              f"blocks, {index.anchor_bit.size} anchors, index "
              f"{idx.stat().st_size} B")


if __name__ == "__main__":
    main()
