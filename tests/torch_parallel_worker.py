"""One rank of a gloo world on the CPU for the tests of
``zlibes_tpu_torch.parallel`` (not collected by pytest):

    python tests/torch_parallel_worker.py <suite> <host:port> <world> <rank> <outdir>

Imports the port alone, like ``tests/mh_worker.py`` does for the
reference.  Joins a gloo process group of ``world`` ranks (with a timeout
of its own, so a hang fails instead of waiting), runs every case of
``suite`` in that one world, and pickles each case's result to
``<outdir>/<case>.r<rank>.pkl``: what the case returned, or the class and
message of what it raised.  The tests spawn one world a test file
(``run_world``) and compare the results with the reference's; the inputs
are the functions below, which the tests call too.
"""
from __future__ import annotations

import datetime
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
RAW = (ROOT / "tests" / "golden" / "raw.bin").read_bytes()
# seconds: a collective or the rendezvous that waits longer fails the rank
COLLECTIVE_TIMEOUT = 90
# seconds a whole world may take before its processes are killed
WORLD_TIMEOUT = 300


# ---------------------------------------------------------------------------
# inputs (the tests build the reference's from the same functions)

def roundtrip_data() -> bytes:
    rng = np.random.default_rng(3)
    return (b"mesh-sharded deflate " * 500) + rng.integers(
        0, 256, 2048, dtype=np.uint8).tobytes()


def adler_data() -> bytes:
    return b"adler over the mesh" * 321


def generic_data() -> bytes:
    return (b"0123456789abcdef" * 2000) + b"tail"


def ratio_data() -> bytes:
    return RAW[:200000]


def dryrun_data() -> tuple[bytes, bytes]:
    """The two inputs of ``__graft_entry__.dryrun_multichip``."""
    rng = np.random.default_rng(42)
    text = b"block parallel deflate over a TPU mesh - " * 200
    data = text + rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    data3 = (text * 8) + rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    return data, data3


def multihost_data() -> bytes:
    """``tests/mh_worker.py``'s input at the 16 blocks of 8 KiB its comment
    means (its ``(base * 3)[: 16 * 8192]`` is 67,800 bytes, 9 blocks), so
    that each of two ranks holds exactly half."""
    rng = np.random.default_rng(42)
    base = (b"multi host deflate over DCN " * 700
            + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes())
    return (base * 6)[: 16 * 8192]


def stored_data() -> bytes:
    """Text around 20,000 random bytes, which the host model stores."""
    rng = np.random.default_rng(9)
    return (RAW[:30000] + rng.integers(0, 256, 20000, np.uint8).tobytes()
            + RAW[30000:50000])


BATCH_DICT = b"the quick brown fox jumps over the lazy dog " * 40


def batch_payloads() -> list[bytes]:
    rng = np.random.default_rng(5)
    return [
        (b"fox dog quick lazy " * rng.integers(3, 40)) +
        rng.integers(0, 256, int(rng.integers(0, 200)),
                     dtype=np.uint8).tobytes()
        for _ in range(37)
    ]


PREFIX = 131072     # the bytes of raw.bin the fixture's prefix digests cover
PREFIX_MODES = {    # parallel_bench.json's modes, at block_size 16384
    "dynamic": dict(block_size=16384),
    "fixed": dict(block_size=16384, dynamic=False),
    "turbo": dict(block_size=16384, turbo=True, with_index=True),
}


def index_sha256(index) -> str:
    """SHA-256 of a StreamIndex's arrays (either package's): the (blocks, 7)
    int64 table of its BlockInfo fields, then anchor_bit, anchor_out and
    anchor_block as int64."""
    import hashlib

    table = np.asarray([[b.btype, int(b.bfinal), b.start_bit,
                         b.payload_start_bit, b.end_bit, b.out_start,
                         b.out_len] for b in index.blocks], np.int64)
    h = hashlib.sha256(table.tobytes())
    for a in (index.anchor_bit, index.anchor_out, index.anchor_block):
        h.update(np.asarray(a, np.int64).tobytes())
    return h.hexdigest()


def corrupt_payload(stream: bytes, index, n: int = 64) -> bytes:
    """``stream`` with ``n`` bytes in the middle of its last coded block's
    payload set to 0xFF (runs of the longest codes, which every decoder
    flags): a fault in the last rank's span only."""
    blk = [b for b in index.blocks if b.btype != 0 and b.out_len][-1]
    mid = (blk.payload_start_bit + blk.end_bit) // 16
    bad = bytearray(stream)
    bad[mid : mid + n] = b"\xff" * n
    return bytes(bad)


# ---------------------------------------------------------------------------
# the cases of each suite: case(mesh) -> result

def _suites():
    import zlibes_tpu_torch as zt
    from zlibes_tpu_torch import parallel as P
    from zlibes_tpu_torch.codec import deflate_pipeline as dp
    from zlibes_tpu_torch.parallel import multihost
    from zlibes_tpu_torch.spec import refmodel as rm

    def index_arrays(index):
        return dict(blocks=[tuple(vars(b).values()) for b in index.blocks],
                    anchor_bit=index.anchor_bit, anchor_out=index.anchor_out,
                    anchor_block=index.anchor_block, turbo=index.turbo,
                    chunk_reset=index.chunk_reset,
                    max_tokens=index.max_tokens)

    # --- tests/test_torch_parallel.py: the twins of tests/test_parallel.py
    # and of __graft_entry__.dryrun_multichip
    def roundtrip(mesh):
        return P.parallel_deflate(roundtrip_data(), mesh, block_size=2048,
                                  seg_size=256)

    def adler(mesh):
        return P.parallel_deflate(adler_data(), mesh, block_size=1024,
                                  seg_size=256)

    def inflate_generic(mesh):
        comp, index = rm.deflate(generic_data(), block_size=4096,
                                 with_index=True, anchor_every=1024)
        return P.parallel_inflate(comp, index, mesh)

    def ratio(mesh):
        dyn, index = P.parallel_deflate(ratio_data(), mesh, block_size=16384,
                                        with_index=True)
        fix = P.parallel_deflate(ratio_data(), mesh, block_size=16384,
                                 dynamic=False)
        return dict(dynamic=dyn, fixed=fix, index=index_arrays(index),
                    inflated=P.parallel_inflate(dyn, index, mesh))

    def dryrun(mesh):
        data, data3 = dryrun_data()
        comp = P.parallel_deflate(data, mesh, block_size=2048, seg_size=256)
        comp2, index = rm.deflate(data, block_size=2048, with_index=True,
                                  anchor_every=512)
        comp3, index3 = P.parallel_deflate(data3, mesh, block_size=16384,
                                           turbo=True, with_index=True)
        body4, index4 = dp.deflate_raw(data3, 16384,
                                       config=zt.CodecConfig.from_level(2),
                                       device="cpu")
        assert index4.wide
        return dict(deflate=comp, deflate_back=rm.inflate(comp),
                    generic=P.parallel_inflate(comp2, index, mesh),
                    turbo=comp3, turbo_back=rm.inflate(comp3),
                    turbo_inflate=P.parallel_inflate(comp3, index3, mesh),
                    wide=P.parallel_inflate(body4, index4, mesh))

    # --- tests/test_torch_parallel_turbo.py
    def prefix(mesh):
        out = {}
        for mode, kw in PREFIX_MODES.items():
            res = P.parallel_deflate(RAW[:PREFIX], mesh, **kw)
            if isinstance(res, tuple):
                out[mode + "_index"] = index_arrays(res[1])
                out[mode + "_inflated"] = P.parallel_inflate(*res, mesh)
                res = res[0]
            out[mode] = res
        return out

    def host_stream(mesh):
        data = RAW[:98304]
        comp, index = dp.deflate(data, with_index=True,
                                 config=zt.CodecConfig.turbo(candidates=4,
                                                             probe_words=4),
                                 block_size=16384, device="cpu")
        return P.parallel_inflate(comp, index, mesh)

    def _corrupt(mesh, comp, index):
        bad = corrupt_payload(comp, index)
        try:
            P.parallel_inflate(bad, index, mesh)
        except zt.CorruptError as exc:
            # __cause__: this rank's own decode failed; else another's did
            return dict(raised="CorruptError", own=exc.__cause__ is not None)
        return dict(raised=None)

    def corrupt_turbo(mesh):
        comp, index = dp.deflate(RAW[:65536], with_index=True,
                                 config=zt.CodecConfig.turbo(),
                                 block_size=16384, device="cpu")
        return _corrupt(mesh, comp, index)

    def corrupt_wide(mesh):
        comp, index = dp.deflate(RAW[:65536], with_index=True,
                                 config=zt.CodecConfig.from_level(1),
                                 block_size=16384, device="cpu")
        assert index.wide
        return _corrupt(mesh, comp, index)

    def corrupt_generic(mesh):
        comp, index = rm.deflate(RAW[:32768], block_size=8192,
                                 with_index=True, anchor_every=1024)
        return _corrupt(mesh, comp, index)

    def stored_blocks(mesh):
        """A generic index whose stored blocks sit between and after the
        coded ones, and a level-0 stream (stored blocks, no anchors)."""
        data = stored_data()
        comp, wide = dp.deflate(data, with_index=True, level=6,
                                block_size=8192, device="cpu")
        assert [b.btype for b in wide.blocks if b.out_len].count(0) == 2
        # a generic index of the same stream: one lane a coded block
        first = np.unique(wide.anchor_block, return_index=True)[1]
        index = rm.StreamIndex(wide.blocks, wide.anchor_bit[first],
                               wide.anchor_out[first],
                               wide.anchor_block[first])
        comp0, index0 = dp.deflate(data, level=0, with_index=True,
                                   device="cpu")
        assert index0.anchor_bit.size == 0
        return dict(mixed=P.parallel_inflate(comp, index, mesh),
                    stored=P.parallel_inflate(comp0, index0, mesh))

    # --- tests/test_torch_batch.py: the twin of tests/test_dictionary.py::
    # test_compress_batch_mesh_broadcast
    def batch(mesh):
        members = P.compress_batch(batch_payloads(), BATCH_DICT, mesh=mesh)
        return dict(members=members,
                    back=P.decompress_batch(members, BATCH_DICT,
                                            device="cpu"))

    # --- tests/test_torch_multihost.py: the twin of tests/mh_worker.py
    def provider(mesh):
        data = multihost_data()
        N = 8192
        n = len(data)
        nblocks = -(-n // N)
        DBd = mesh.size * (-(-nblocks // mesh.size))
        lo, hi = multihost.host_shard(DBd)
        served = []

        def block_provider(i):
            served.append(i)
            # a real deployment reads only [i*N, (i+1)*N) of its source
            return data[i * N : (i + 1) * N]

        comp = P.parallel_deflate(None, mesh, block_size=N, seg_size=1024,
                                  n_bytes=n, block_provider=block_provider)
        stream2, index2 = rm.deflate(data, block_size=8192, with_index=True,
                                     anchor_every=2048)
        return dict(comp=comp, served=served, shard=(lo, hi), n=n,
                    staged=sum(1 for i in served if i < nblocks) * N,
                    inflated=P.parallel_inflate(stream2, index2, mesh),
                    world=mesh.size)

    return {
        "parallel": dict(roundtrip=roundtrip, adler=adler,
                         inflate_generic=inflate_generic, ratio=ratio,
                         dryrun=dryrun),
        "turbo": dict(prefix=prefix, host_stream=host_stream,
                      corrupt_turbo=corrupt_turbo,
                      corrupt_wide=corrupt_wide,
                      corrupt_generic=corrupt_generic,
                      stored_blocks=stored_blocks),
        "batch": dict(batch=batch),
        "multihost": dict(provider=provider,
                          host_shard_uneven=lambda mesh: multihost.host_shard(
                              2 * mesh.size + 1)),
    }


def main() -> None:
    suite, addr, world, rank, outdir = (sys.argv[1], sys.argv[2],
                                        int(sys.argv[3]), int(sys.argv[4]),
                                        Path(sys.argv[5]))
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    from zlibes_tpu_torch.parallel import make_mesh, multihost

    group = dist.group.WORLD
    multihost.initialize(addr, world, rank, device="cpu")   # a no-op now
    assert dist.group.WORLD is group
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (rank, world)
    for name, case in _suites()[suite].items():
        try:
            res = dict(value=case(mesh))
        except Exception as exc:        # recorded for the test to read
            res = dict(error=type(exc).__name__, message=str(exc))
        with open(outdir / f"{name}.r{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "zlibes_tpu"))
    assert not loaded, loaded
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests' side

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(suite: str, world: int, outdir: Path) -> dict:
    """Spawn ``world`` ranks of this script on ``suite`` and wait for them
    -> {case: [result of rank 0, rank 1, ...]}; a rank that fails or
    outlives WORLD_TIMEOUT fails the call with its output."""
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), suite, addr,
         str(world), str(r), str(outdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORLD_TIMEOUT)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {suite} failed:\n{out[-3000:]}"
    results: dict = {}
    for path in sorted(outdir.glob("*.r*.pkl")):
        case, r = path.stem.rsplit(".r", 1)
        results.setdefault(case, {})[int(r)] = pickle.loads(path.read_bytes())
    return {case: [by_rank[r] for r in range(world)]
            for case, by_rank in results.items()}


def value(results: dict, case: str):
    """The case's result, the same on every rank (bytes and arrays compared
    exactly); a case that raised fails with its message."""
    ranks = results[case]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res['error']}: {res['message']}"
    first = ranks[0]["value"]
    for res in ranks[1:]:
        assert _same(res["value"], first)
    return first


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


if __name__ == "__main__":
    main()
