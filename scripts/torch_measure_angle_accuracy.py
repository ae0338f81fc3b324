#!/usr/bin/env python
"""Angle accuracy against planted truth, on a CUDA device and on the CPU (twin of ``measure_angle_accuracy.py``, ``"f32"`` only).

The same planted scenes as ``scripts/measure_angle_accuracy.py``: seed 99,
256 frames of the flagship configuration, each with one strong target at a
known range, velocity, azimuth and elevation drawn across the field of view
(the port's simulator, a bit-equal copy of the JAX package's).  The port's
point-cloud pipeline (``bench.py``'s CFAR and antenna sets, 128 detections
a frame) runs on ``--device`` and on the CPU.  For the detection nearest
each planted (range, velocity) cell, the azimuth is held against the truth
(RMSE, 90th percentile and maximum of |error|, the JAX report's statistics,
for each device), and the two devices' picks against each other: a matched
frame is an angle bin apart when its azimuths differ, or when one device
matched the target and the other did not.

Accuracy against the truth is reported, not gated: the matching ignores
angle wrap (a known defect of the JAX script, which this twin keeps so
that the two reports compare).  Writes ``--out`` (default
``ANGLE_ACCURACY_TORCH.json``) and prints the report.

Example (from the repository root):
    python scripts/torch_measure_angle_accuracy.py            # the card against the CPU
    python scripts/torch_measure_angle_accuracy.py --device cpu --frames 16
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_tpu_torch.utils.verify import (
    AZ_IDXS, CFAR_PARAMS, EL_IDXS, flagship_config,
)

N_FRAMES = 256
SEED = 99
#: a match is the detection nearest the planted (range, velocity), within this distance
MATCH_RADIUS = 0.15
#: azimuths of one detection on two devices that differ by more than this are a bin apart
#: (the 64-bin grid's steps are 1.8 degrees or more; a shared pick agrees within 1e-5)
SAME_PICK_RAD = 1e-3


def make_truth_frames(n_frames: int = N_FRAMES, seed: int = SEED):
    """``(cfg, raw_re, raw_im, truths)``: float32 planes ``[n, 4, 63, 210]`` and ``[n, 4]`` truths (range, velocity, azimuth, elevation)."""
    from mmwave_radar_processing_tpu_torch.data import PointTarget, Scene, simulate_frame

    cfg = flagship_config()
    rng = np.random.default_rng(seed)
    raws, truths = [], []
    for _ in range(n_frames):
        az = float(rng.uniform(-0.9, 0.9))
        el = float(rng.uniform(-0.45, 0.45))
        r = float(rng.uniform(0.35, 0.85) * cfg.range_max_m)
        v = float(rng.uniform(-0.6, 0.6) * cfg.vel_max_m_s)
        scene = Scene(
            targets=[PointTarget(range_m=r, azimuth_rad=az,
                                 elevation_rad=el, velocity_m_s=v, rcs=6.0)],
            noise_sigma=0.05,
        )
        raws.append(simulate_frame(cfg, scene, rng))
        truths.append((r, v, az, el))
    raw = np.stack(raws)
    return (cfg, np.ascontiguousarray(raw.real, np.float32),
            np.ascontiguousarray(raw.imag, np.float32),
            np.asarray(truths, np.float32))


def matched_azimuths(points, valid, truths):
    """The azimuth of the detection nearest each frame's planted (range, velocity), NaN where none is within ``MATCH_RADIUS``."""
    az = np.full(points.shape[0], np.nan)
    for f in range(points.shape[0]):
        pts = points[f][valid[f].astype(bool)]
        if not len(pts):
            continue
        r_t, v_t, _, _ = truths[f]
        d = np.hypot(np.linalg.norm(pts[:, :3], axis=1) - r_t, pts[:, 3] - v_t)
        k = int(np.argmin(d))
        if d[k] <= MATCH_RADIUS:
            az[f] = np.arctan2(pts[k, 1], pts[k, 0])
    return az


def angle_stats(az, truths):
    """The JAX report's statistics of the matched frames' azimuth errors (degrees)."""
    errs = (az - truths[:, 2])[np.isfinite(az)]
    if not errs.size:  # no detection matched the planted target on any frame
        return {"n_matched": 0, "rmse_deg": None, "p90_abs_deg": None, "max_abs_deg": None}
    return {"n_matched": int(errs.size),
            "rmse_deg": float(np.rad2deg(np.sqrt(np.mean(errs ** 2)))),
            "p90_abs_deg": float(np.rad2deg(np.quantile(np.abs(errs), 0.9))),
            "max_abs_deg": float(np.rad2deg(np.max(np.abs(errs))))}


def run_pipeline(cfg, raw_re, raw_im, device):
    """The port's point-cloud pipeline on ``device``: ``(points, valid)`` on the host."""
    import torch

    from mmwave_radar_processing_tpu_torch import build_point_cloud_pipeline

    pipe = build_point_cloud_pipeline(cfg, az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
                                      cfar_params=CFAR_PARAMS, max_dets=128, device=device)
    out = pipe(torch.from_numpy(raw_re).to(device), torch.from_numpy(raw_im).to(device))
    return out.points.cpu().numpy(), out.valid.cpu().numpy()


def measure(device, n_frames: int = N_FRAMES, seed: int = SEED):
    """The report: statistics on ``device`` and on the CPU, and how the two devices' picks agree."""
    cfg, raw_re, raw_im, truths = make_truth_frames(n_frames, seed)
    azs = {}
    for name in dict.fromkeys((str(device), "cpu")):
        azs[name] = matched_azimuths(*run_pipeline(cfg, raw_re, raw_im, name), truths)
    got, want = azs[str(device)], azs["cpu"]
    both = np.isfinite(got) & np.isfinite(want)
    one = np.isfinite(got) != np.isfinite(want)
    bin_apart = both & (np.abs(np.nan_to_num(got) - np.nan_to_num(want)) > SAME_PICK_RAD)
    apart = int(bin_apart.sum() + one.sum())
    either = int((both | one).sum())
    return {"n_frames": n_frames, "seed": seed, "aoa_precision": "f32",
            "angle_grid_step_deg": float(np.rad2deg(np.arcsin(2.0 / 64) * 2)),
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "devices": {name: angle_stats(az, truths) for name, az in azs.items()},
            "device": str(device),
            "frames_matched_on_both": int(both.sum()),
            "frames_matched_on_one_only": int(one.sum()),
            "frames_angle_bin_apart": int(bin_apart.sum()),
            "apart_share": apart / max(either, 1)}


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device held against the CPU (default cuda; cpu only when asked for)")
    p.add_argument("--frames", type=int, default=N_FRAMES)
    p.add_argument("--out", default="ANGLE_ACCURACY_TORCH.json")
    args = p.parse_args()

    report = measure(args.device, args.frames)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
