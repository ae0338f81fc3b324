#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's velocity pipeline on one GPU.

    python3 torch_velocity_stages.py [--batch 1024] [--out FILE]

Run from the repository root on a machine with a CUDA device.  On the
flagship config with ``bench.py``'s inputs (standard normal planes, seed 0,
altitude 1.2), for the coarse and the precise (zoom) pipeline it prints one
JSON line each:

- ``prefix_ms_median``: device ms per forward of the pipeline cut with
  ``stop_after`` (``responses``: the altitude window, range and chirp DFTs
  and the response kernel; ``vx``: the zero-azimuth readout; ``peaks``: the
  zoom pass, if any, and the row peaks; ``full``: RANSAC and the gates),
  median of ``--reps`` runs of ``--iters`` forwards (CUDA events after
  warm-up), and ``stage_ms``, the differences of successive prefixes;
- ``profile``: the device busy share over 10 full forwards under
  ``torch.profiler`` and the kernels that take the most time.

``--out`` also writes every line to a file.
"""

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch import build_velocity_pipeline, load_cfg
from torch_pointcloud_stages import busy_share, device_ms

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_CFG = os.path.join(HERE, "configs", "6843_RadVel_ods_20Hz.cfg")
PREFIXES = ("responses", "vx", "peaks", None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_velocity_stages.py needs a CUDA device")

    lines = []

    def emit(**fields):
        lines.append(json.dumps(fields))
        print(lines[-1], flush=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    device = torch.device("cuda", 0)
    cfg = load_cfg(FLAGSHIP_CFG, array_geometry="ods", array_direction="down")
    rng = np.random.default_rng(0)
    shape = (args.batch, cfg.num_rx_antennas, cfg.num_adc_samples,
             cfg.chirps_per_frame)
    raw_re, raw_im = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                      .to(device) for _ in "ri")
    alts = torch.full((args.batch,), 1.2, device=device)

    for mode, precise in (("coarse", False), ("precise", True)):
        prefix_ms = {}
        for cut in PREFIXES:
            p = build_velocity_pipeline(cfg, enable_precise=precise, stop_after=cut,
                                        device=device)
            fn = lambda: p(raw_re, raw_im, alts)  # noqa: E731
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            reps = [device_ms(fn, args.iters) for _ in range(args.reps)]
            prefix_ms[cut or "full"] = float(np.median(reps))
        names = list(prefix_ms)
        stage_ms = {names[0]: prefix_ms[names[0]]}
        stage_ms.update({b: prefix_ms[b] - prefix_ms[a]
                         for a, b in zip(names, names[1:])})
        emit(mode=mode, batch=args.batch, prefix_ms_median=prefix_ms,
             stage_ms=stage_ms, frames_per_s=args.batch / (prefix_ms["full"] / 1e3),
             peak_mem_mb=torch.cuda.max_memory_allocated(device) / 1e6)
        emit(mode=mode, batch=args.batch, profile=busy_share(fn, top=20))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
