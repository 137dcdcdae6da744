"""Run one cell of the benchmark of ``zlibes_tpu_torch`` once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It loads the kernels (built into
``build/zlibes_tpu_torch/`` inside the checkout at the first run), makes the
cell's data from the seed, runs the set-up its traffic needs, warms up,
measures for ``--seconds``, judges what the port returned against the plain
reference, and prints one JSON object as the last line of standard output
(with ``--trace 1`` the per-layer metrics, from a ``torch.profiler`` trace
of the window, else the end-to-end ones).  The numbers compared for
``correct`` are the last lines of standard error and the result's last key.

Without the CUDA cards the cell asks for, it exits with 2 and prints no
result; it never runs on the CPU.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process, few threads: the port's host work is single-threaded Python
# and NumPy, and idle worker threads only add noise to a host-bound window
THREADS = "2"
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, THREADS)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH_JSON = ROOT / "BENCHMARK.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec
    from harness.cell import forbidden_modules, log, run_cell

    chips = spec.load_cell(BENCH_JSON, args.workload).chips
    import torch

    torch.set_num_threads(int(THREADS))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        return 2
    if chips > 1:
        from harness.ranks import run_ranks

        result = run_ranks(chips, BENCH_JSON, args.workload, args.seed,
                           args.seconds, bool(args.trace), "cuda", T_START)
    else:
        result = run_cell(BENCH_JSON, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process, which the benchmark forbids: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(HERE), str(ROOT)]
    sys.exit(main())
