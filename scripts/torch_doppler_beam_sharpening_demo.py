#!/usr/bin/env python
"""Doppler beam sharpening on simulated forward motion, with the PyTorch port (twin of ``doppler_beam_sharpening_demo.py``).

Simulates a moving platform that sees five static scatterers, and draws the
plain range-angle response beside the DBS-sharpened one.  The processor
runs on ``--device`` (default cuda; the CPU only when asked for), the
drawing on the host.

Example (from the repository root):
    python scripts/torch_doppler_beam_sharpening_demo.py --out dbs_demo.png
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_tpu_torch.config import load_cfg
from mmwave_radar_processing_tpu_torch.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_tpu_torch.plotting import PlotterMmWaveData
from mmwave_radar_processing_tpu_torch.processors.base import to_host
from mmwave_radar_processing_tpu_torch.processors.dbs import RangeAngleProcessorDBSEnhanced
from mmwave_radar_processing_tpu_torch.processors.virtual_array import VirtualArrayReformatter
from mmwave_radar_processing_tpu_torch.utils.logger import setup_logger

RX = [0, 3, 4, 7]


def responses(cfg, vx: float, device):
    """``(processor, plain, sharpened)``: the range-angle responses of the seeded scene, on the host."""
    rng = np.random.default_rng(0)
    vel = np.array([vx, 0.0, 0.0])
    # static scatterers: a Doppler of -cos(angle) * vx seen from the moving platform
    targets = []
    for az_deg in (-35, -15, 0, 20, 40):
        az = np.deg2rad(az_deg)
        r = rng.uniform(1.0, 3.0)
        u = np.array([np.cos(az), np.sin(az), 0.0])
        targets.append(
            PointTarget(range_m=r, azimuth_rad=az, velocity_m_s=-float(u @ vel),
                        rcs=3.0, phase_rad=rng.uniform(0, 2 * np.pi))
        )
    raw = simulate_frame(cfg, Scene(targets=targets, noise_sigma=0.03), rng)
    virt = VirtualArrayReformatter(cfg, device=device).process(raw)
    proc = RangeAngleProcessorDBSEnhanced(
        cfg, num_angle_bins_range_angle_response=64,
        num_angle_bins_dbs_enhanced_response=100, min_x_y_vel_dbs=0.25, device=device,
    )
    plain = to_host(proc.process_no_dbs(virt, rx_antennas=RX))
    sharpened = to_host(proc.process_dbs_enhanced(virt, vel, rx_antennas=RX))
    return proc, plain, sharpened


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/6843_RadVel_ods_20Hz.cfg")
    p.add_argument("--out", default="dbs_demo.png")
    p.add_argument("--vx", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="torch device of the processor (default cuda; cpu only when asked for)")
    args = p.parse_args()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    logger = setup_logger()
    cfg = load_cfg(args.config, "ods", "down")
    proc, plain, sharpened = responses(cfg, args.vx, args.device)

    plotter = PlotterMmWaveData(cfg)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    proc.compute_mesh_grid()
    plotter.plot_range_azimuth_heatmap_polar(plain, proc, ax=axes[0])
    axes[0].set_title("Range-Angle (no DBS)")
    proc.compute_mesh_grid_dbs_enhanced()
    plotter.plot_range_azimuth_heatmap_polar(sharpened, proc, ax=axes[1])
    axes[1].set_title(f"DBS-sharpened (vx={args.vx} m/s)")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    logger.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
