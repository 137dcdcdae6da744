"""A cell of several chips: one process a rank, one card a rank.

The run's own process is rank 0; it starts the others (``spawn``), and all
meet over TCP on localhost at a free port: NCCL for the program on the
cards (gloo on the CPU), and a gloo group of the harness's own for rank 0's
decisions and the ranks' reports.  Rank 0 returns the result; the others
exit, and rank 0 waits for each before it returns.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import sys
import time
from pathlib import Path

JOIN_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_body(rank: int, world: int, port: int, bench_json: str,
              workload: str, seed: int, seconds: float, trace: bool,
              device_type: str, t_start: float, fault, control):
    import torch
    import torch.distributed as dist

    from .cell import Ranks, run_cell

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device_type == "cuda":
        torch.set_num_threads(2)
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        backend = "nccl"
    else:
        # the ranks share the host's cores: one thread each
        torch.set_num_threads(1)
        device = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        ctrl = dist.new_group(backend="gloo")
        return run_cell(Path(bench_json), workload, seed, seconds, trace,
                        device, t_start, Ranks(rank, world, ctrl), fault,
                        control)
    finally:
        dist.destroy_process_group()


def rank_main(*args):
    """A spawned rank (1 and up)."""
    rank_body(*args[:9], time.perf_counter(), *args[9:])


def run_ranks(world: int, bench_json: Path, workload: str, seed: int,
              seconds: float, trace: bool, device_type: str, t_start: float,
              fault=None, control=False):
    port = free_port()
    ctx = mp.get_context("spawn")
    common = (world, port, str(bench_json), workload, seed, seconds, trace,
              device_type)
    procs = [ctx.Process(target=rank_main,
                         args=(r, *common, fault, control))
             for r in range(1, world)]
    for p in procs:
        p.start()
    ok = False
    try:
        result = rank_body(0, *common, t_start, fault, control)
        ok = True
        return result
    finally:
        deadline = time.monotonic() + (JOIN_S if ok else 5)
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if ok and bad:
            print(f"ranks exited with {bad}", file=sys.stderr)
            raise RuntimeError(f"a rank failed: exit codes {bad}")
