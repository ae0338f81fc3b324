"""Run one cell of the benchmark of ``mmwave_radar_processing_tpu_torch`` once, on this machine's card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It needs a CUDA device: without one, or
with fewer than the cell asks for, it exits with code 2 and prints no
result.  It prints the numbers that decide ``correct`` beside their limits
as the last lines of standard error, and one JSON object as the last line
of standard output.  It exits with code 3, and prints no result, when the
process holds JAX or the JAX package once the window has closed.  Kernels
the program builds go to ``build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench.lib.harness import Cell, forbidden_modules, run_cell

    chips = int(Cell.load(args.workload).spec.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda:0", t_start=T_START)
    held = forbidden_modules()
    if held:
        print(f"port_bench: the process holds {held}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
