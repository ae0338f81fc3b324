#!/usr/bin/env python
"""Aggregate ego-velocity error analysis over several datasets with the PyTorch port (twin of ``test_multi_vel_estimation.py``).

Runs the single-dataset flow (``torch_test_vel_estimation.py``) over every
dataset listed in a multi-dataset YAML and prints per-dataset and pooled
error reports.  The processors run on ``--device`` (default cuda; the CPU
only when asked for).

YAML format:
    datasets:
      - path: /tmp/sim_a
      - path: /tmp/sim_b
    radar: { config_file: ..., array_geometry: ..., array_direction: ... }
    processors: { ... same as velocity_analysis_config ... }
    analysis: { start_idx: ..., end_idx: ..., error_method: signed }
    transformation: { uav_vel_matrix: ..., gt_vel_matrix: ... }
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_tpu_torch.utils.env import load_env

load_env()

from mmwave_radar_processing_tpu_torch.analysis import VelocityAnalyzer, analyze_velocity
from mmwave_radar_processing_tpu_torch.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_tpu_torch.utils.logger import setup_logger
from torch_test_vel_estimation import load_radar_cfg


def main():
    import yaml

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked for)")
    args = p.parse_args()

    logger = setup_logger()
    with open(args.config) as f:
        params = yaml.safe_load(f)
    cfg = load_radar_cfg(params, params["radar"]["config_file"], args.config)

    all_est, all_gt = [], []
    method = params.get("analysis", {}).get("error_method", "signed")
    for entry in params["datasets"]:
        path = entry["path"] if isinstance(entry, dict) else entry
        logger.info("analyzing %s", path)
        est, gt = analyze_velocity(CpslDS(path), cfg, params, device=args.device)
        analyzer = VelocityAnalyzer()
        analyzer.analyze(est, gt, error_method=method)
        print(f"\n==== {os.path.basename(path)} ====")
        print(analyzer.generate_report().to_string())
        all_est.append(est)
        all_gt.append(gt)

    pooled = VelocityAnalyzer()
    pooled.analyze(np.concatenate(all_est), np.concatenate(all_gt),
                   error_method=method)
    print("\n==== pooled over all datasets ====")
    print(pooled.generate_report().to_string())


if __name__ == "__main__":
    main()
