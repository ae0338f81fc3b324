#!/usr/bin/env python
"""Batch-process a recording on a CUDA device with the PyTorch port (twin of ``process_recording.py``).

Streams a CPSL recording through the port's frame-batched pipelines: the
native NPY loader fills pinned host batches on a background thread, each
batch is copied to the device on a side stream while the previous one
computes, and point clouds and ego-velocities (or the ground altitude) come
back into host arrays.  Writes the same ``.npz`` as ``process_recording.py``
(keys ``points``, ``valid`` and ``velocity`` or ``altitude``) and logs the
per-stage timing.  Runs on the CPU only when given ``--device cpu``.

Example (from the repository root):
    python scripts/torch_simulate_dataset.py --out /tmp/sim_radvel --frames 300
    python scripts/torch_process_recording.py --dataset /tmp/sim_radvel \
        --out /tmp/processed.npz --batch 64
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_tpu_torch.utils.env import load_env, resolve_dir

load_env()

from mmwave_radar_processing_tpu_torch.config import load_cfg
from mmwave_radar_processing_tpu_torch.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_tpu_torch.parallel.recording import process_recording
from mmwave_radar_processing_tpu_torch.utils.logger import setup_logger
from mmwave_radar_processing_tpu_torch.utils.profiling import StageTimer


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--radar-config", default="configs/6843_RadVel_ods_20Hz.cfg")
    p.add_argument("--array-geometry", default="ods")
    p.add_argument("--array-direction", default="down")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--altitude", type=float, default=1.2,
                   help="range-window center for the velocity pipeline")
    p.add_argument("--max-dets", type=int, default=128)
    p.add_argument("--loader-threads", type=int, default=8)
    p.add_argument("--no-velocity", action="store_true")
    p.add_argument("--detector", choices=["2d", "ground"], default="2d",
                   help="2d: OS-CFAR-2D detector + ADC-path velocity; "
                        "ground: altitude-gated detector (stateful altimeter "
                        "scan)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked for)")
    args = p.parse_args()

    logger = setup_logger()
    cfg = load_cfg(resolve_dir(args.radar_config, "CONFIG_DIRECTORY"),
                   args.array_geometry, args.array_direction)
    dataset = CpslDS(resolve_dir(args.dataset, "DATASET_DIRECTORY"))
    mode = ("ground" if args.detector == "ground"
            else "points" if args.no_velocity else "2d")
    logger.info("%d frames, mode %s, device %s", dataset.num_frames, mode, args.device)

    timer = StageTimer()
    out = process_recording(dataset, cfg, mode=mode, batch=args.batch,
                            altitude=args.altitude, max_dets=args.max_dets,
                            loader_threads=args.loader_threads, device=args.device,
                            timer=timer)
    np.savez_compressed(args.out, **out)
    logger.info("wrote %s (%d frames)", args.out, len(out["points"]))
    timer.log_report()


if __name__ == "__main__":
    main()
