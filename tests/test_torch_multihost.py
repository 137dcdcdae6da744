"""Twin, for the PyTorch port, of ``tests/test_multihost.py`` (two
processes, ``tests/mh_worker.py``): two gloo ranks on localhost
(``tests/torch_parallel_worker.py``) run the block-parallel encode with a
``block_provider`` that each rank asks only for its ``host_shard`` rows;
plus ``multihost.initialize`` / ``global_mesh`` / ``host_shard`` in a
world of one in this process.
"""
import socket
import zlib as pyzlib

import pytest
import torch
import torch.distributed as dist

import torch_parallel_worker as w

from zlibes_tpu_torch import parallel as P
from zlibes_tpu_torch.parallel import multihost

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return w.run_world("multihost", 2, tmp_path_factory.mktemp("multihost"))


@pytest.fixture
def group_of_one():
    """A gloo process group of one rank in this process, torn down after."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert not dist.is_initialized()
    try:
        yield f"127.0.0.1:{port}"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_process_block_provider(world):
    """Each rank's provider is asked only for rows inside its host_shard;
    each rank stages at most half the input; both ranks return the
    reference's bytes, which CPython accepts."""
    from zlibes_tpu.parallel import make_mesh, parallel_deflate

    data = w.multihost_data()
    ranks = [r.get("value", r) for r in world["provider"]]
    assert all("error" not in r for r in ranks), ranks
    want = parallel_deflate(data, make_mesh(8), block_size=8192,
                            seg_size=1024)
    for rank, r in enumerate(ranks):
        lo, hi = r["shard"]
        assert r["n"] == 16 * 8192 and (lo, hi) == (8 * rank, 8 * rank + 8)
        assert r["served"] and set(r["served"]) <= set(range(lo, hi))
        assert r["staged"] <= (hi - lo) * 8192 < r["n"]
        assert 2 * r["staged"] <= r["n"]
        assert r["comp"] == want
        assert r["inflated"] == data and r["world"] == 2
    assert pyzlib.decompress(ranks[0]["comp"]) == data


def test_host_shard_refuses_a_count_the_world_does_not_divide(world):
    for r in world["host_shard_uneven"]:
        assert r.get("error") == "ValueError", r
        assert "not divisible by 2" in r["message"]


def test_host_shard_without_a_group():
    assert multihost.host_shard(16) == (0, 16)
    assert multihost.global_mesh(device="cpu").size == 1


def test_initialize_tcp_world_of_one(group_of_one):
    """initialize() over tcp:// joins a gloo group; again it is a no-op; a
    mesh over the group runs its collectives and gives the bytes of the
    world without a group."""
    multihost.initialize(group_of_one, 1, 0, device="cpu")
    group = dist.group.WORLD
    assert dist.get_backend() == "gloo"
    multihost.initialize(group_of_one, 1, 0, device="cpu")
    assert dist.group.WORLD is group
    mesh = multihost.global_mesh(device="cpu")
    assert mesh.group is not None and (mesh.rank, mesh.size) == (0, 1)
    with pytest.raises(ValueError, match="whole group"):
        P.make_mesh(2, device="cpu")
    assert multihost.host_shard(3) == (0, 3)
    P.LAST_TIMINGS.clear()
    comp = P.parallel_deflate(w.adler_data(), mesh, block_size=1024,
                              seg_size=256, with_index=True)
    assert P.LAST_TIMINGS["collective"] > 0
    alone = P.parallel_deflate(w.adler_data(), P.block_parallel.Mesh(
        None, 0, 1, torch.device("cpu")), block_size=1024, seg_size=256,
        with_index=True)
    assert comp[0] == alone[0]
    assert P.parallel_inflate(*comp, mesh) == w.adler_data()


def test_initialize_env_world_of_one(group_of_one, monkeypatch):
    host, port = group_of_one.split(":")
    for k, v in dict(MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE="1",
                     RANK="0").items():
        monkeypatch.setenv(k, v)
    multihost.initialize(device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1


def test_initialize_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        multihost.initialize("127.0.0.1:1", 1, 0, device="cuda")
    assert not dist.is_initialized()
