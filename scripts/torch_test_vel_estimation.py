#!/usr/bin/env python
"""Ego-velocity error analysis over one dataset with the PyTorch port (twin of ``test_vel_estimation.py``).

Raw ADC frames -> virtual-array reformat -> ground-gated point clouds ->
points-based RANSAC ego velocity -> per-axis error statistics against the
odometry's ground truth, configured by a YAML analyzer configuration
(``analyzer_configs/velocity_analysis_config.yaml`` format, with the
frame-transformation matrices).  The processors run on ``--device``
(default cuda; the CPU only when asked for); ``--plot-out`` draws the
analysis summary figure on the host.

Example (from the repository root):
    python scripts/torch_simulate_dataset.py --out /tmp/sim_radvel --frames 120
    python scripts/torch_test_vel_estimation.py \
        --config analyzer_configs/velocity_analysis_config.yaml \
        --dataset /tmp/sim_radvel
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_tpu_torch.utils.env import load_env, resolve_dir

load_env()

from mmwave_radar_processing_tpu_torch.analysis import VelocityAnalyzer, analyze_velocity
from mmwave_radar_processing_tpu_torch.config import load_cfg
from mmwave_radar_processing_tpu_torch.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_tpu_torch.utils.logger import setup_logger


def resolve_radar_cfg(radar_cfg_file: str, yaml_path: str) -> str:
    """Resolve a relative radar .cfg: CONFIG_DIRECTORY, YAML-relative, repo."""
    if os.path.isabs(radar_cfg_file):
        return radar_cfg_file
    candidates = [
        resolve_dir(radar_cfg_file, "CONFIG_DIRECTORY"),
        os.path.join(os.path.dirname(os.path.abspath(yaml_path)), "..",
                     "configs", radar_cfg_file),
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "configs", radar_cfg_file),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    return candidates[-1]


def load_radar_cfg(params: dict, radar_cfg_file: str, yaml_path: str):
    return load_cfg(
        resolve_radar_cfg(radar_cfg_file, yaml_path),
        params["radar"].get("array_geometry", "standard"),
        params["radar"].get("array_direction", "down"),
    )


def main():
    import yaml

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="analyzer_configs/velocity_analysis_config.yaml")
    p.add_argument("--dataset", default=None,
                   help="override the dataset path from the YAML")
    p.add_argument("--radar-config", default=None)
    p.add_argument("--start-idx", type=int, default=None)
    p.add_argument("--end-idx", type=int, default=None)
    p.add_argument("--plot-out", default=None,
                   help="write the analysis summary figure here")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked for)")
    args = p.parse_args()

    logger = setup_logger()
    with open(args.config) as f:
        params = yaml.safe_load(f)

    dataset_path = args.dataset or resolve_dir(
        os.path.join(params["dataset"]["path"], params["dataset"]["name"]),
        "DATASET_DIRECTORY",
    )
    cfg = load_radar_cfg(params, args.radar_config or params["radar"]["config_file"],
                         args.config)
    logger.info("\n%s", cfg.overview())

    est, gt = analyze_velocity(CpslDS(dataset_path), cfg, params, device=args.device,
                               start=args.start_idx, end=args.end_idx, logger=logger)
    analyzer = VelocityAnalyzer()
    analyzer.analyze(est, gt,
                     error_method=params.get("analysis", {}).get("error_method", "signed"))
    report = analyzer.generate_report()
    print("\n==== velocity error report ====")
    print(report.to_string())

    if args.plot_out:
        import matplotlib

        matplotlib.use("Agg")
        from mmwave_radar_processing_tpu_torch.plotting import AnalysisPlotter

        fig = AnalysisPlotter().plot_summary(analyzer)
        fig.savefig(args.plot_out, dpi=100)
        logger.info("wrote %s", args.plot_out)
    return report


if __name__ == "__main__":
    main()
