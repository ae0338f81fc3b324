#!/usr/bin/env python
"""CFAR verification of the PyTorch port on synthetic oracles (twin of ``verify_detectors.py``).

Exponential noise with planted targets, the same seed, six cases and pass
rule as ``scripts/verify_detectors.py``: every CFAR variant must detect the
target and keep its detections under 5% of the cells.  Prints the same
pass/fail table and exits nonzero when a row fails.  On a CUDA device
``os_cfar_1d`` launches the k-th-smallest kernel and ``os_cfar_2d`` the
noise-map kernel (``csrc/os_rank_select.cu``).  Runs on the CPU only when
given ``--device cpu``.

Example (from the repository root):
    python scripts/torch_verify_detectors.py --device cpu
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_tpu_torch.detectors import get_detector_registry


def cases(seed: int = 0):
    """``(detector, params, signal, target)`` of each row, signals drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    x1 = rng.exponential(1.0, 120)
    x1[50] += 30.0
    x2 = rng.exponential(1.0, (64, 64))
    x2[20, 30] += 40.0
    return [
        ("ca_cfar_1d", dict(num_train=8, num_guard=2, pfa=1e-3), x1, 50),
        ("go_cfar_1d", dict(num_train=8, num_guard=2, pfa=1e-3), x1, 50),
        ("so_cfar_1d", dict(num_train=8, num_guard=2, pfa=1e-3), x1, 50),
        ("os_cfar_1d", dict(num_train=8, num_guard=2, rho=0.75, alpha=6.0), x1, 50),
        ("ca_cfar_2d", dict(num_train=(5, 5), num_guard=(3, 2), pfa=1e-3), x2, (20, 30)),
        ("os_cfar_2d", dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0), x2, (20, 30)),
    ]


def run(device, seed: int = 0):
    """One dict a row: ``name``, ``hit``, ``detections`` (the list ``detect`` returned), ``ok``."""
    registry = get_detector_registry()
    rows = []
    for name, params, signal, target in cases(seed):
        dets = registry[name](**params, device=device).detect(signal)
        hit = target in dets
        rows.append(dict(name=name, hit=hit, detections=dets,
                         ok=hit and len(dets) < signal.size * 0.05))
    return rows


def table(rows) -> str:
    lines = [f"{'detector':<12} {'target hit':<11} {'detections':<11} result"]
    lines += [f"{r['name']:<12} {str(r['hit']):<11} {len(r['detections']):<11} "
              f"{'PASS' if r['ok'] else 'FAIL'}" for r in rows]
    return "\n".join(lines)


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback from one to the other")
    args = p.parse_args()
    rows = run(args.device, args.seed)
    print(table(rows))
    sys.exit(0 if all(r["ok"] for r in rows) else 1)


if __name__ == "__main__":
    main()
