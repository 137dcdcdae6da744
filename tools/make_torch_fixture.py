"""Generate the committed bench fixtures (streams + sidecar indexes).

The PyTorch port (``zlibes_tpu_torch``) has no encoder yet, and the machine
that runs it on a GPU has no JAX, so the bench-sized streams its decoder is
measured on are made here, once, by the JAX package's encoder on the CPU
backend:

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py

Writes, from the bench corpus:

  * ``tests/golden/turbo_bench.{zz,idx.npz}`` — ``CodecConfig.turbo()``;
  * ``tests/golden/wide_bench.{zz,idx.npz}`` — ``CodecConfig.from_level(6)``
    (zlib's default level: the default-profile stream with wide anchors).
"""
from __future__ import annotations

import sys
import zlib as pyzlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.make_bench_fixture import bench_data  # noqa: E402


def main() -> None:
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
