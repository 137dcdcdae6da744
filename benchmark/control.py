"""The checks of the comparison that decides ``correct``, at a cell's own
size on the card: the cell's control (the plain reference in the program's
place with one guarantee broken, ``reference/controls.py``) or a fault
planted in the port's timed path (``harness/substitutes.py``), on several
seeds, each with a short window:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 5 [--fault flip]

Prints one JSON line a seed: ``correct`` (which has to be false) and the
numbers compared.  The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import BENCH_JSON, HERE, ROOT  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import spec
    from harness.cell import run_cell
    from harness.ranks import run_ranks

    chips = spec.load_cell(BENCH_JSON, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        kw = dict(fault=args.fault, control=args.fault is None)
        if chips > 1:
            res = run_ranks(chips, BENCH_JSON, args.workload, seed,
                            args.seconds, False, "cuda", t, **kw)
        else:
            res = run_cell(BENCH_JSON, args.workload, seed, args.seconds,
                           False, torch.device("cuda", 0), t, **kw)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "substitute": args.fault or "control",
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(HERE), str(ROOT)]
    sys.exit(main())
