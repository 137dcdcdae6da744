"""The port stands alone: it imports nothing of ``zlibes_tpu`` and no JAX,
and the copies it keeps (``spec``, ``config``, ``ops/huffman``,
``runtime/native``) agree with the reference's.

The JAX package is imported here as the reference only, and only by the
comparisons of the last section; the first two sections look at the port
from outside (a fresh interpreter, the sources).
"""
import re
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

import zlibes_tpu.config as jconfig
from zlibes_tpu.ops import huffman as jhuffman
from zlibes_tpu.runtime import native as jnative
from zlibes_tpu.spec import constants as JC
from zlibes_tpu.spec import refmodel as jrefmodel

import zlibes_tpu_torch.config as config
from zlibes_tpu_torch.ops import huffman
from zlibes_tpu_torch.runtime import native
from zlibes_tpu_torch.spec import constants as C
from zlibes_tpu_torch.spec import refmodel

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "zlibes_tpu_torch"

# ---------------------------------------------------------------------------
# (a) a fresh interpreter: every module of the port, and one call of each
# entry point on the CPU, leave JAX and zlibes_tpu out of sys.modules

_DRIVE = r"""
import pkgutil, sys, zlib
import zlibes_tpu_torch as zt
names = [m.name for m in pkgutil.walk_packages(zt.__path__, "zlibes_tpu_torch.")]
for name in names:
    __import__(name)
assert len(names) >= 20, names
data = (b"the quick brown fox jumps over the lazy dog. " * 300)[:9000]
from zlibes_tpu_torch.codec import deflate_pipeline as dp
comp, index = dp.deflate(data, with_index=True, config=zt.CodecConfig.turbo(),
                         block_size=4096, device="cpu")
assert zlib.decompress(comp) == data
assert zt.deflate(data, config=zt.CodecConfig.turbo(), block_size=4096,
                  device="cpu") == comp
assert zt.inflate(comp, index=index, device="cpu") == data
assert zt.inflate_range(comp, index, 4090, 20, device="cpu") == data[4090:4110]
(out, off, n), = zt.inflate_to_device(comp, index, device="cpu")
assert out[:n].numpy().tobytes() == data
from zlibes_tpu_torch.config import trace
with trace("zlibes.match"):
    pass
for name in ("zlibes_tpu_torch.ops.lz77",
             "zlibes_tpu_torch.ops.deflate_kernel",
             "zlibes_tpu_torch.codec.deflate_pipeline",
             "zlibes_tpu_torch.codec.api"):
    assert name in names, name
# the general encoder: a level, the default config with its index, a preset
# dictionary, level 0, and the host model behind backend=
wide, windex = zt.deflate_indexed(data, block_size=4096, device="cpu")
assert windex.wide and zlib.decompress(wide) == data
assert zt.deflate(data, level=6, block_size=4096, device="cpu") == wide
assert zt.inflate(wide, index=windex, device="cpu") == data
assert zt.inflate_range(wide, windex, 4090, 20,
                        device="cpu") == data[4090:4110]
assert zlib.decompress(zt.deflate(data, level=0, device="cpu")) == data
fdict = zt.deflate(data, level=1, dictionary=data[:500], block_size=4096,
                   device="cpu")
assert zlib.decompressobj(zdict=data[:500]).decompress(fdict) == data
host, hindex = zt.deflate_indexed(data, backend="refmodel")
assert zt.deflate(data, backend="refmodel") == host
assert zt.inflate(host, backend="refmodel") == data
# a generic index (the host model's): the seek and the device output
# through the group decode, and the scan of a stream without an index
assert not hindex.wide and not hindex.turbo
assert zt.inflate_range(host, hindex, 4090, 20,
                        device="cpu") == data[4090:4110]
(gout, goff, gn), = zt.inflate_to_device(host, hindex, device="cpu")
assert (goff, gn) == (0, len(data)) and gout.numpy().tobytes() == data
from zlibes_tpu_torch.codec import inflate_pipeline as ip
sout, _, _ = ip.inflate_raw_scan(zlib.compress(data[:3000], 6), 2,
                                 device="cpu")
assert sout.numpy().tobytes() == data[:3000]
for name in ("zlibes_tpu_torch.ops.inflate_kernel",
             "zlibes_tpu_torch.codec.inflate_pipeline"):
    assert name in names, name
from zlibes_tpu_torch.runtime import native
if native.available():
    assert zt.inflate(zlib.compress(data, 6), device="cpu") == data
# block parallelism at world 1 (no process group): both encodes, the three
# inflates, the dictionary batch and the multi-host helpers
from zlibes_tpu_torch import parallel as P
mesh = P.make_mesh(1, device="cpu")
pcomp, pindex = P.parallel_deflate(data, mesh, block_size=4096, turbo=True,
                                   with_index=True)
assert zlib.decompress(pcomp) == data
assert P.parallel_inflate(pcomp, pindex, mesh) == data
assert P.parallel_inflate(wide, windex, mesh) == data
assert P.parallel_inflate(host, hindex, mesh) == data
assert zlib.decompress(P.parallel_deflate(data, mesh, block_size=4096,
                                          dynamic=False)) == data
members = P.compress_batch([data[:300], data[300:900]], data[-2000:],
                           device="cpu")
assert P.decompress_batch(members, data[-2000:],
                          device="cpu") == [data[:300], data[300:900]]
assert P.multihost.host_shard(4) == (0, 4)
for name in ("zlibes_tpu_torch.parallel.block_parallel",
             "zlibes_tpu_torch.parallel.batch",
             "zlibes_tpu_torch.parallel.multihost"):
    assert name in names, name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "zlibes_tpu"))
assert not bad, bad
print("modules", len(names))
"""


def test_port_runs_without_jax_and_reference_package():
    res = subprocess.run([sys.executable, "-c", _DRIVE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("modules ")


# ---------------------------------------------------------------------------
# (b) the sources: no import of zlibes_tpu or jax in the port or the smoke

_IMPORT = re.compile(
    r"^\s*(from|import)\s+(zlibes_tpu|jax|jaxlib)(\.[\w.]+)?(\s|$)", re.M)
SOURCES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) \
    + ["chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_jax_nor_reference_package(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _IMPORT.finditer(text)]
    assert not hits, hits
    assert "__import__(\"zlibes_tpu\"" not in text
    assert "import_module(\"zlibes_tpu\"" not in text


def test_import_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import zlibes_tpu",
                 "    from zlibes_tpu.spec import constants as C",
                 "import jax.numpy as jnp"):
        assert _IMPORT.search(line), line
    for line in ("import zlibes_tpu_torch", "from zlibes_tpu_torch import x",
                 "# import jax", "from .spec import constants"):
        assert not _IMPORT.search(line), line


@pytest.mark.parametrize("path", ["tests/test_torch_cuda.py",
                                  "tests/test_torch_fixed_streams.py",
                                  "tests/test_torch_contract_cases.py",
                                  "tests/torch_parallel_worker.py"])
def test_card_tests_import_neither_jax_nor_reference_package(path):
    assert not _IMPORT.search((ROOT / path).read_text())


# ---------------------------------------------------------------------------
# (c) the port's copies agree with the reference's

CONSTANTS = sorted(n for n in vars(C) if n.isupper())


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_equals_reference(name):
    got, want = getattr(C, name), getattr(JC, name)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("fn", ["fixed_litlen_code_lengths",
                                "fixed_dist_code_lengths",
                                "build_length_code_table",
                                "build_dist_code_table"])
def test_constant_tables_equal_reference(fn):
    got, want = getattr(C, fn)(), getattr(JC, fn)()
    if isinstance(want, tuple):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    else:
        assert np.array_equal(got, want)
    assert sorted(n for n in vars(JC) if n.isupper()) == CONSTANTS


def _code_lengths(seed: int, nsym: int, max_bits: int, batch: int = 3):
    """Seeded complete-or-short code lengths of ``batch`` blocks (package-
    merge of random frequencies, some symbols unused)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(batch):
        freqs = rng.integers(0, 2000, nsym) * (rng.random(nsym) < 0.7)
        freqs[rng.integers(0, nsym)] += 1
        rows.append(jrefmodel.package_merge_lengths(freqs, max_bits))
    return np.stack(rows).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind,nsym,max_bits", [("litlen", 288, 9),
                                                ("litlen", 288, 15),
                                                ("dist", 32, 9),
                                                ("dist", 32, 15)])
def test_huffman_tables_equal_reference(kind, nsym, max_bits, seed):
    lengths = _code_lengths(seed, nsym, max_bits)
    assert np.array_equal(huffman.canonical_codes_batch(lengths),
                          jhuffman.canonical_codes_batch(lengths))
    build = f"build_{kind}_tables"
    assert np.array_equal(getattr(huffman, build)(lengths, max_bits),
                          getattr(jhuffman, build)(lengths, max_bits))
    assert np.array_equal(huffman._REV16, jhuffman._REV16)


def _stream_data(seed: int, n: int = 6000) -> bytes:
    rng = np.random.default_rng(seed)
    text = b"It was the best of times, it was the worst of times. " * 40
    return (text[: n // 2] + rng.integers(0, 256, n // 4, np.uint8).tobytes()
            + b"ab" * (n // 8))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("seed", [0, 1])
def test_refmodel_inflate_and_adler32_equal_reference(seed, level):
    data = _stream_data(seed)
    comp = zlib.compress(data, level)
    assert refmodel.inflate(comp) == jrefmodel.inflate(comp) == data
    assert refmodel.adler32(data) == jrefmodel.adler32(data) \
        == zlib.adler32(data)
    got, want = refmodel.inflate_raw(comp, 2), jrefmodel.inflate_raw(comp, 2)
    assert got.end_bit == want.end_bit
    assert [tuple(vars(b).values()) for b in got.blocks] == \
        [tuple(vars(b).values()) for b in want.blocks]


def test_refmodel_deflate_equals_reference():
    data = _stream_data(3, 3000)
    assert refmodel.deflate(data) == jrefmodel.deflate(data)
    assert zlib.decompress(refmodel.deflate(data)) == data


@pytest.mark.parametrize("level", [1, 6, 9])
def test_native_decode_equals_zlib(level):
    """The port's own build of its ``zscan.cc`` decodes foreign streams as
    CPython zlib does, and as the reference's build does."""
    assert native.available()
    data = _stream_data(level, 300000)
    comp = zlib.compress(data, level)
    out, index, end_bit, adler = native.decode(comp, bit_offset=16)
    assert out.tobytes() == data == zlib.decompress(comp)
    assert adler == zlib.adler32(data)
    assert type(index) is refmodel.StreamIndex
    assert index.total_out == len(data)
    if jnative.available():
        jout, jindex, jend, jadler = jnative.decode(comp, bit_offset=16)
        assert (jend, jadler) == (end_bit, adler)
        assert np.array_equal(jout, out)
        assert np.array_equal(jindex.anchor_bit, index.anchor_bit)


def test_native_library_is_the_ports_own():
    """Built from the port's source into ``build/zlibes_tpu_torch/`` under a
    name that the reference's ``libzscan-*.so`` cannot collide with."""
    from zlibes_tpu_torch.runtime import kernels

    assert native.available()
    assert native._SRC == PORT / "runtime" / "zscan.cc"
    assert native.BUILD_DIR == kernels.BUILD_DIR == \
        ROOT / "build" / "zlibes_tpu_torch"
    built = sorted(p.name for p in native.BUILD_DIR.glob("libzscan_torch-*.so"))
    assert built, list(native.BUILD_DIR.iterdir())
    assert not list(native.BUILD_DIR.glob("libzscan-*.so"))


@pytest.mark.parametrize("code,name", [(-1, "BlockTypeError"),
                                       (-2, "TruncatedError"),
                                       (-3, "StoredBlockError"),
                                       (-4, "CorruptError")])
def test_native_raises_the_ports_errors(code, name):
    from zlibes_tpu_torch.spec import errors

    assert native._ERRORS[code][0] is getattr(errors, name)
    assert native._ERRORS[code][0] is not jnative._ERRORS[code][0]


def test_native_truncated_stream_raises_the_ports_error():
    from zlibes_tpu_torch.spec import errors

    comp = zlib.compress(_stream_data(5), 6)
    with pytest.raises(errors.TruncatedError):
        native.decode(comp[: len(comp) // 2], bit_offset=16)


@pytest.mark.parametrize("make", ["default", "turbo", "level0", "level1",
                                  "level6", "level9"])
def test_config_presets_equal_reference(make):
    import dataclasses

    def preset(mod):
        cls = mod.CodecConfig
        if make == "default":
            return cls()
        if make == "turbo":
            return cls.turbo()
        return cls.from_level(int(make[-1]))

    got, want = preset(config), preset(jconfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pack_row_width() == want.pack_row_width()
    assert type(got) is not type(want)
