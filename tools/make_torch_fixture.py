"""Generate the committed turbo bench fixture (stream + sidecar index).

The PyTorch port (``zlibes_tpu_torch``) has no turbo encoder yet, and the
machine that runs it on a GPU has no JAX, so the bench-sized turbo stream
its decoder is measured on is made here, once, by the JAX package's
``CodecConfig.turbo()`` encoder on the CPU backend:

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py

Writes ``tests/golden/turbo_bench.zz`` and ``tests/golden/turbo_bench.idx.npz``.
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
    comp, index = dp.deflate(data, with_index=True, config=CodecConfig.turbo())
    assert index.turbo
    assert pyzlib.decompress(comp) == data
    out_dir = ROOT / "tests" / "golden"
    stream = out_dir / "turbo_bench.zz"
    idx = out_dir / "turbo_bench.idx.npz"
    stream.write_bytes(comp)
    index.save(idx)
    print(f"corpus {len(data)} B -> stream {len(comp)} B "
          f"(ratio {len(comp) / len(data):.4f}), {len(index.blocks)} blocks, "
          f"{index.anchor_bit.size} anchors, index {idx.stat().st_size} B")


if __name__ == "__main__":
    main()
