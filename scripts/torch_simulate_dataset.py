#!/usr/bin/env python
"""Generate a synthetic CPSL-layout dataset with the PyTorch port (twin of ``simulate_dataset.py``).

Raw ADC cubes and odometry ground truth of a simulated UAV flight, from the
port's scene simulator (numpy only, held bit-equal to the JAX package's), so
the same arguments write byte-identical files with either script.

Example (from the repository root):
    python scripts/torch_simulate_dataset.py --out /tmp/sim_radvel --frames 120 \
        --config configs/6843_RadVel_ods_20Hz.cfg --vx 0.5 --altitude 1.2
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_tpu_torch.config import load_cfg
from mmwave_radar_processing_tpu_torch.data import ground_scene, simulate_frame
from mmwave_radar_processing_tpu_torch.data.cpsl_dataset import make_odom_rows, write_dataset
from mmwave_radar_processing_tpu_torch.utils.logger import setup_logger


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True, help="output dataset directory")
    p.add_argument("--config", default="configs/6843_RadVel_ods_20Hz.cfg")
    p.add_argument("--array-geometry", default="ods")
    p.add_argument("--array-direction", default="down")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--altitude", type=float, default=1.2)
    p.add_argument("--altitude-start", type=float, default=0.3,
                   help="takeoff ramp start (the altimeter tracks from "
                        "min_altitude; a gradual ascent keeps it locked)")
    p.add_argument("--ramp-frames", type=int, default=20)
    p.add_argument("--vx", type=float, default=0.5, help="boresight velocity m/s")
    p.add_argument("--vy", type=float, default=0.1)
    p.add_argument("--vz", type=float, default=0.0)
    p.add_argument("--patches", type=int, default=64, help="ground patches/frame")
    p.add_argument("--noise", type=float, default=0.04)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    logger = setup_logger()
    cfg = load_cfg(args.config, args.array_geometry, args.array_direction)
    rng = np.random.default_rng(args.seed)
    ego = np.array([args.vx, args.vy, args.vz])

    frames, odom = [], []
    for i in range(args.frames):
        ramp = min(1.0, i / max(args.ramp_frames, 1))
        alt = args.altitude_start + ramp * (args.altitude - args.altitude_start)
        scene = ground_scene(cfg, altitude_m=alt, ego_vel=ego,
                             num_patches=args.patches, rng=rng,
                             noise_sigma=args.noise)
        frames.append(simulate_frame(cfg, scene, rng))
        odom.append(make_odom_rows(ego))
        if i % 20 == 0:
            logger.info("frame %d/%d", i, args.frames)

    write_dataset(args.out, np.stack(frames), odom=np.stack(odom))
    logger.info("wrote %d frames to %s", args.frames, args.out)


if __name__ == "__main__":
    main()
