#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's point-cloud pipeline on one GPU.

    python3 torch_pointcloud_stages.py [--batches 256,1024,4096] [--out FILE]

Run from the repository root on a machine with a CUDA device.  On the
flagship config (``configs/6843_RadVel_ods_20Hz.cfg``, the default CFAR and
antenna sets) with ``bench.py``'s inputs (standard normal planes, seed 0), it
prints one JSON line per batch size:

- ``ms_per_batch_reps``: device ms per forward (CUDA events around
  ``--iters`` forwards after warm-up), ``--reps`` times, and frames/s;
- ``host_ms_per_batch``: host clock around ``--iters`` forwards and a
  synchronize;
- ``stage_ms_median``: CUDA events between the stages of ``forward``,
  replayed here one by one (median of ``--reps``); the replay is checked to
  give ``forward``'s output exactly; ``cfar_compact`` is the one kernel that
  detects and compacts (``chip_smoke.py`` times it beside the mask entry
  followed by ``mask_to_indices_2d``, the two steps it replaced);

and last, at the largest batch not above 1024, the device busy share over 10
forwards under ``torch.profiler`` (device kernel time / host wall time) with
the kernels that take the most time.  ``--out`` also writes every line to a
file.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch import (
    PointCloudBatch, build_point_cloud_pipeline, load_cfg,
)
from mmwave_radar_processing_tpu_torch.ops import dft
from mmwave_radar_processing_tpu_torch.ops.cfar import os_2d_detect_compact
from mmwave_radar_processing_tpu_torch.processors.point_cloud import (
    spherical_to_cartesian_flu,
)

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_CFG = os.path.join(HERE, "configs", "6843_RadVel_ods_20Hz.cfg")


def inputs(cfg, batch, device):
    rng = np.random.default_rng(0)
    shape = (batch, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(device) for _ in "ri")


def staged_forward(p, raw_re, raw_im):
    """``PointCloudPipeline.forward``, stage by stage, with an event after each."""
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    mark("start")
    raw = torch.complex(raw_re, raw_im)
    mark("complex")
    R = dft.range_dft_channels(raw, p.chans, p.rng_dft, num_rx=p.num_rx,
                               cfgs_per_loop=p.cpl)
    mark("range_dft")
    rd0 = torch.matmul(R[:, p.ch0_pos], p.dop_dft)
    mark("doppler_dft")
    mag = dft.cabs(rd0)
    mark("magnitude")
    r_i, v_i, valid, count = os_2d_detect_compact(mag, p.max_dets, **p.cfar_params)
    mark("cfar_compact")
    vals = dft.rd_values(R[:, p.aoa_start:], p.dop_dft, r_i, v_i)
    mark("rd_values")
    az = dft.aoa_peak_angles(vals, p.az_pos, p.az_dft, p.angle_bins)
    el = dft.aoa_peak_angles(vals, p.el_pos, p.el_dft, p.angle_bins)
    mark("angles")
    pts = spherical_to_cartesian_flu(r_i.to(torch.float32) * p.range_res, az, el,
                                     p.vel0 + v_i.to(torch.float32) * p.vel_res)
    pts = torch.where(valid[..., None], pts, 0.0)
    mark("points")
    torch.cuda.synchronize()
    stage_ms = {name: prev.elapsed_time(event)
                for (_, prev), (name, event) in zip(marks, marks[1:])}
    return PointCloudBatch(pts, valid, count), stage_ms


def device_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def busy_share(fn, forwards=10, top=14):
    """Device kernel time over host wall time for ``forwards`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(forwards):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    kernel_us = sum(us for us, _, _ in rows)
    return {"forwards": forwards, "wall_us": wall_us, "kernel_us": kernel_us,
            "device_busy_share": kernel_us / wall_us,
            "top_kernels": [{"us_per_forward": us / forwards, "name": key[:90],
                             "calls": calls} for us, key, calls in rows[:top]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="256,1024,4096")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_pointcloud_stages.py needs a CUDA device")

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
    p = build_point_cloud_pipeline(cfg, device=device)

    batches = [int(b) for b in args.batches.split(",")]
    for batch in batches:
        raw_re, raw_im = inputs(cfg, batch, device)
        for _ in range(3):
            want = p(raw_re, raw_im)
        torch.cuda.synchronize()
        reps = [device_ms(lambda: p(raw_re, raw_im), args.iters)
                for _ in range(args.reps)]
        t0 = time.perf_counter()
        for _ in range(args.iters):
            p(raw_re, raw_im)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / args.iters * 1e3
        staged = [staged_forward(p, raw_re, raw_im) for _ in range(args.reps)]
        got = staged[-1][0]
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError("the staged replay differs from forward()")
        median = {name: float(np.median([s[name] for _, s in staged]))
                  for name in staged[0][1]}
        emit(batch=batch, ms_per_batch_reps=reps,
             frames_per_s_reps=[batch / (ms / 1e3) for ms in reps],
             host_ms_per_batch=host_ms, stage_ms_median=median,
             stage_sum_ms=sum(median.values()))
        del raw_re, raw_im, want, staged, got

    batch = max([b for b in batches if b <= 1024] or [min(batches)])
    raw_re, raw_im = inputs(cfg, batch, device)
    for _ in range(3):
        p(raw_re, raw_im)
    torch.cuda.synchronize()
    emit(batch=batch, profile=busy_share(lambda: p(raw_re, raw_im)))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
