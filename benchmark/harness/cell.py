"""One run of one cell: set-up, warm-up, the measured window, the judgement
and the result line.

``run_cell`` is the whole run on a device it is given; ``run.py`` gives it
the card after checking that the cell's cards are there, and the tests give
it the CPU.  A cell of several chips runs one process a rank
(``harness/ranks.py``); every rank runs ``run_cell`` and rank 0 returns
the result.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import corpus, spec
from .ops import OPS
from .traffic import Schedule, file_specs

FORBIDDEN = ("jax", "jaxlib", "flax", "zlibes_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Ranks:
    """This process's place among the cell's ranks (a world of one when
    ``group`` is None): ``go(flag)`` makes every rank follow rank 0's
    decision."""

    def __init__(self, rank: int = 0, world: int = 1, group=None):
        self.rank, self.world, self.group = rank, world, group

    def go(self, flag: bool) -> bool:
        if self.group is None:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)])
        dist.broadcast(t, 0, group=self.group)
        return bool(t.item())

    def gather(self, obj) -> list:
        if self.group is None:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self):
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)


def window(op, schedule: Schedule, seconds: float, ranks: Ranks):
    """Requests back to back until ``seconds`` have passed; a request that
    started inside the window runs to its end.  Returns (t0, t_end)."""
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while ranks.go(time.perf_counter() < deadline):
        item = schedule.item(i)
        i += 1
        op.attempted += 1
        t = time.perf_counter()
        try:
            res = op.call(item)
        except Exception as exc:        # a failed request is counted
            if ranks.group is not None:
                raise
            op.failed += 1
            log(f"request {i - 1} ({item}) failed: {exc!r}")
            continue
        op.record(item, res, t, time.perf_counter())
    return t0, time.perf_counter()


def per_second(calls, t0: float, t_end: float) -> list[float]:
    """The work (bytes or reads) of the requests that ended in each second
    of the window."""
    out = [0.0] * max(1, int(t_end - t0) + 1)
    for _, _, t1, w in calls:
        out[min(len(out) - 1, int(t1 - t0))] += w
    return out


def build_kernels(device: torch.device) -> float:
    if device.type != "cuda":
        return 0.0
    from zlibes_tpu_torch.runtime import kernels

    t = time.perf_counter()
    kernels.library()
    return time.perf_counter() - t


def run_cell(bench_json: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             ranks: Ranks | None = None, fault: str | None = None,
             control: bool = False) -> dict | None:
    """Run ``workload`` once; the result line's object on rank 0, None on
    the other ranks."""
    ranks = ranks or Ranks()
    cell = spec.load_cell(bench_json, workload)
    from . import codec
    from .devtrace import DeviceTrace, start_profiler
    from .substitutes import plant_control, plant_fault

    log(f"harness started {time.perf_counter() - t_start:.3f} s after the "
        f"process")
    if device.type == "cuda":
        t = time.perf_counter()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        log(f"CUDA context {time.perf_counter() - t:.3f} s")
    build_s = build_kernels(device)
    log(f"kernels loaded in {build_s:.3f} s (the first run of a checkout "
        f"compiles them)")
    mesh = codec.make_mesh(device) if cell.chips > 1 else None
    files = file_specs(cell.config, cell.traffic["files"])
    t = time.perf_counter()
    raw = corpus.raw_corpus()
    datas = [corpus.make_file(raw, f.size, seed, f.index) for f in files]
    log(f"data: {len(files)} files, {sum(map(len, datas))} B in "
        f"{time.perf_counter() - t:.3f} s")
    encoder = codec.Encoder(cell.config, device, mesh, cell.bench_dir)
    name = cell.traffic["op"]
    op_class = (OPS[name] if name in OPS
                else spec.plugin(cell.bench_dir, "ops", name).Op)
    op = op_class(encoder, files, datas, device, seed)
    schedule = Schedule(cell.traffic, files, seed)
    t = time.perf_counter()
    op.setup()
    log(f"traffic set-up {time.perf_counter() - t:.3f} s")
    if fault:
        plant_fault(op, fault)
    if control:
        log(f"control: {plant_control(op, ranks.world)}")
    t = time.perf_counter()
    op.warm()
    log(f"warm-up {time.perf_counter() - t:.3f} s")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ranks.barrier()
    # what set-up made stays for the whole run: keep the collector's scans
    # of the window to what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    prof = start_profiler() if trace else None
    t0, t_end = window(op, schedule, seconds, ranks)
    gc.unfreeze()
    dtrace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        t = time.perf_counter()
        dtrace = DeviceTrace(prof, t_end - t0)
        del prof
        log(f"trace read in {time.perf_counter() - t:.3f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log("work a second of the window: " + " ".join(
        f"{w:.4g}" for w in per_second(op.calls, t0, t_end)))
    op.after_window()
    run = SimpleNamespace(op=op, trace=dtrace, window_s=t_end - t0,
                          setup_s=setup_s, config=cell.config, files=files,
                          stream_arrays=lambda i: (
                              op.streams[i][0],
                              codec.index_arrays(op.streams[i][1])))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(cell.bench_dir, m.name)(run)
        if v is None and not trace:
            raise RuntimeError(f"end-to-end metric {m.name} has no value")
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    index_kind = "wide" if (op.kind == "compress"
                            and encoder.api == "deflate_indexed") else None
    busy = dtrace.busy_s if dtrace is not None else None
    # every rank: what it ran and what it saw, for rank 0
    mine = {"digests": op.digests() if op.kind == "compress" else None,
            "peak": peak, "busy": busy, "attempted": op.attempted,
            "failed": op.failed}
    every = ranks.gather(mine)
    if ranks.rank != 0:
        return None
    t = time.perf_counter()
    found = op.judge(index_kind)
    checks = {k: int(v) for k, v in found.items() if k.startswith("bad_")}
    if op.kind == "compress" and ranks.world > 1:
        checks["bad_rank_streams"] = sum(
            int(r["digests"] != every[0]["digests"]) for r in every[1:])
    checks["failed_requests"] = sum(r["failed"] for r in every)
    log(f"judged in {time.perf_counter() - t:.3f} s: "
        + ", ".join(f"{k} {v}" for k, v in found.items()))
    correct = all(v == 0 for v in checks.values()) and op.attempted > 0
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": ranks.world,
               "memory_peak_bytes": int(max(r["peak"] for r in every))}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": ranks.world,
               "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": op.attempted,
              "failed": sum(r["failed"] for r in every), "metrics": metrics,
              "device": dev}
    if dtrace is not None:
        dev["busy_s"] = sum(r["busy"] for r in every) / len(every)
        dev["window_s"] = t_end - t0
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": dtrace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": 0} for k, v in
                        checks.items()}
    return result
