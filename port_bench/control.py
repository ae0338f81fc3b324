"""Readings of the check's numbers for the control (the reference in TF32) or a planted fault.

    python3 port_bench/control.py --workload <cell> --seeds 11,12,13 [--in-place control] [--seconds 1]

Each seed is one run of the cell's set-up, a short window and the check, all
in this process, with in the program's place: ``control`` (the reference in
TF32), ``program`` (the program itself: the lower readings), or a planted
fault (``lib/faults.py``).  One JSON line a seed: the cell, seed, what stood
in the program's place, ``correct`` and every number with its limit.  The
benchmark's own runs never run this; its readings set the limits.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--in-place", default="control")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    from port_bench.lib.harness import run_cell

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = run_cell(args.workload, seed=seed, seconds=args.seconds, trace=False,
                          device=args.device, t_start=t0,
                          fault=None if args.in_place in ("control", "program") else args.in_place,
                          control=args.in_place == "control")
        print(json.dumps({"workload": args.workload, "seed": seed, "in_place": args.in_place,
                          "correct": result["correct"], "checks": result["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
