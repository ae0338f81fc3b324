"""One step of the whole multi-device program on small shapes (JAX: ``__graft_entry__.dryrun_multichip``).

:func:`dryrun_multichip` starts ``world_size`` ranks (:func:`.launch.spawn`)
on a ``(data, model)`` mesh, with ``model = 2`` where the world size is
even, as the JAX package builds it, and each rank runs :func:`dryrun_rank`:

1. the point-cloud pipeline, frame-parallel over ``data``;
2. synthetic-aperture beamforming, element-sharded over ``model``, one
   all-reduce;
3. OS-CFAR 1D, range-sharded over ``data``, with the halo exchange;
4. the combined pipeline fed by each rank's NPY loads
   (:func:`.input_feed.sharded_recording_feed`), frame-parallel;
5. snapshot-sharded Capon over ``model``, one all-reduce;
6. the overlap-save zoom, sample-sharded over ``model``.

The configuration is the flagship's with 32 samples and 16 loops, the JAX
dry run's.  Each rank checks its outputs' shapes and that they are finite,
and returns them with its kernels' launches.
"""

from __future__ import annotations

import dataclasses
import tempfile
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from mmwave_radar_processing_tpu_torch.config import grids
from mmwave_radar_processing_tpu_torch.ops.kernels import count_launches
from mmwave_radar_processing_tpu_torch.utils.verify import flagship_config

DRYRUN_CFAR = dict(num_train=(3, 3), num_guard=(1, 1), rho=0.7, alpha=4.0)


def tiny_config():
    """The flagship configuration cut to 32 samples and 16 loops (the JAX dry run's)."""
    cfg = flagship_config()
    profile = dataclasses.replace(cfg.profiles[0], adc_samples=32)
    frame = dataclasses.replace(cfg.frame, loops=16)
    return dataclasses.replace(cfg, profiles=[profile], frame=frame).derive()


def dryrun_rank(device: torch.device, seed: int = 0) -> Dict:
    """One rank's step of the dry run; returns its outputs' shapes and its launches."""
    (sizes, results), launches = count_launches(lambda: _steps(device, seed))
    for name, (got, want, finite) in results.items():
        if tuple(got.shape) != want:
            raise RuntimeError(f"dry run, {name}: shape {tuple(got.shape)}, expected {want}")
        if finite and not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"dry run, {name}: non-finite output on rank {dist.get_rank()}")
    return {"rank": dist.get_rank(), "mesh": sizes,
            "shapes": {name: list(got.shape) for name, (got, _, _) in results.items()},
            "launches": launches}


def _steps(device: torch.device, seed: int):
    """The six steps: ``(mesh sizes, {name: (output, expected shape, must be finite)})``."""
    from mmwave_radar_processing_tpu_torch.ops import beamform as bf, windows
    from mmwave_radar_processing_tpu_torch.parallel.full_pipeline import build_full_pipeline
    from mmwave_radar_processing_tpu_torch.parallel.halo_cfar import os_cfar_1d_sharded
    from mmwave_radar_processing_tpu_torch.parallel.input_feed import sharded_recording_feed
    from mmwave_radar_processing_tpu_torch.parallel.mesh import (
        axis_index, frame_slice, make_mesh,
    )
    from mmwave_radar_processing_tpu_torch.parallel.overlap_save import build_sharded_zoom_fir
    from mmwave_radar_processing_tpu_torch.parallel.pipeline import (
        build_point_cloud_pipeline, shard_pipeline,
    )
    from mmwave_radar_processing_tpu_torch.parallel.scaling import write_feed_frames
    from mmwave_radar_processing_tpu_torch.parallel.sharded_beamform import (
        build_sharded_beamformer, build_snapshot_sharded_capon,
    )

    world = dist.get_world_size()
    model = 2 if world % 2 == 0 else 1
    data_size = world // model
    mesh = make_mesh({"data": data_size, "model": model}, device_type=device.type)
    cfg = tiny_config()
    rng = np.random.default_rng(seed)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def model_slice(n: int) -> slice:
        per = n // model
        i = axis_index(mesh, "model")
        return slice(i * per, (i + 1) * per)

    # 1. frame-parallel point cloud over data
    batch = 2 * world
    shape = (batch, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    raw_re = rng.standard_normal(shape).astype(np.float32)
    raw_im = rng.standard_normal(shape).astype(np.float32)
    frames = frame_slice(mesh, batch, "data")
    pipeline = shard_pipeline(build_point_cloud_pipeline(
        cfg, az_antenna_idxs=(0, 3, 4, 7), el_antenna_idxs=(9, 8, 5, 4),
        cfar_params=DRYRUN_CFAR, max_dets=32, device=device), mesh)
    pc = pipeline(tensor(raw_re[frames]), tensor(raw_im[frames]), global_batch=batch)

    # 2. element-sharded synthetic-aperture beamforming over model
    ns, n_angles, elements = cfg.num_adc_samples, 24, 8 * model
    data = (rng.standard_normal((ns, elements))
            + 1j * rng.standard_normal((ns, elements))).astype(np.complex64)
    positions = (rng.standard_normal((3, elements)) * 0.01).astype(np.float32)
    theta = np.linspace(-0.5, 0.5, n_angles)
    steering = np.stack([np.cos(theta), np.sin(theta), np.zeros_like(theta)],
                        axis=1).astype(np.float32)
    elems = model_slice(elements)
    beam = build_sharded_beamformer(mesh, lambda_m=cfg.lambda_m)
    resp = beam(tensor(data[:, elems]), tensor(positions[:, elems]), tensor(steering),
                tensor(windows.hanning(ns)), tensor(windows.hamming(elements)[elems]))

    # 3. range-sharded OS-CFAR 1D with the halo exchange over data
    signal = rng.exponential(1.0, 64 * data_size).astype(np.float32)
    cells = frame_slice(mesh, signal.shape[0], "data")
    cfar = os_cfar_1d_sharded(mesh, num_train=4, num_guard=2, rho=0.5, alpha=2.0, axis="data")
    thr = cfar(tensor(signal[cells]))

    # 4. the combined pipeline fed by this rank's own NPY loads
    combined = shard_pipeline(build_full_pipeline(cfg, cfar_params=DRYRUN_CFAR, max_dets=32,
                                                  device=device), mesh)
    pc2 = vel = None
    with tempfile.TemporaryDirectory(prefix="mrp_dryrun_") as td:
        paths = write_feed_frames(td, shape[1:], n=batch, seed=seed)
        for args in sharded_recording_feed(mesh, paths, shape[1:], global_batch=batch,
                                           altitude=1.2, device=device):
            pc2, vel = combined(*args, global_batch=batch)

    # 5. snapshot-sharded Capon over model
    n_ant, k_per = 12, 8
    snaps = (rng.standard_normal((ns, n_ant, k_per * model))
             + 1j * rng.standard_normal((ns, n_ant, k_per * model))).astype(np.complex64)
    capon = build_snapshot_sharded_capon(mesh, loading=1e-2, axis="model")
    power = capon(tensor(snaps[..., model_slice(k_per * model)]),
                  bf.steering_ula(grids.phase_shift_bins(24), n_ant).to(device))

    # 6. overlap-save sample-sharded zoom over model
    n_samp = 64 * model
    zoom = build_sharded_zoom_fir(mesh, n=n_samp, f_center=0.25, fs=2.0, decim=4,
                                  num_taps=17, m=16, f1=-0.2, f2=0.2, axis="model")
    zr = rng.standard_normal((2, n_samp)).astype(np.float32)
    spectrum = zoom(tensor((zr[:, model_slice(n_samp)] * (1 + 1j)).astype(np.complex64)))

    local_batch = frames.stop - frames.start
    return {"data": data_size, "model": model}, {
        "point_cloud": (pc.points, (local_batch, 32, 4), True),
        "beamform": (resp, (ns, n_angles), True),
        # +inf thresholds at the signal's true ends
        "os_cfar_1d": (thr, (cells.stop - cells.start,), False),
        "combined_points": (pc2.points, (local_batch, 32, 4), True),
        "combined_velocity": (vel.velocity, (local_batch, 3), True),
        "capon": (power, (ns, 24), True),
        "zoom": (spectrum, (2, 16), True)}


def dryrun_multichip(world_size: int, *, backend: str, device, timeout: float = 600.0
                     ) -> List[Dict]:
    """Run the dry run on ``world_size`` ranks; returns each rank's summary."""
    from mmwave_radar_processing_tpu_torch.parallel.launch import spawn

    return spawn(dryrun_rank, world_size, backend=backend, device=device, timeout=timeout)
