"""Bulk traffic: a recording's frames resident in device memory, processed in batches back to back.

The mix gives ``pipeline`` (``combined``: point clouds and ego-velocity,
``parallel/full_pipeline.py``; ``pointcloud``: point clouds alone,
``parallel/pipeline.py``), ``frames`` and ``batch``.  Set-up makes the
frames and their altitudes on the device from the seed, and the RANSAC draws
of every frame from a stream of their own; it builds the pipeline with the
configuration's parameters and runs it once on one batch, whose outputs are
thrown away.

The window is a closed loop over the batches in turn, each at least once:
each call's outputs are copied into pinned host buffers (one slot a frame)
without waiting, and the window ends in a synchronize.  ``frames_per_s`` is every frame whose
outputs reached the host over the wall time of the whole window.

The check samples ``sample_frames`` frames (drawn from the seed) of the
outputs the last pass left, and runs the plain reference on the same
inputs and draws.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.gen import scene
from port_bench.lib import compare
from port_bench.lib.trace import span
from port_bench.reference import pointcloud as ref_pc
from port_bench.reference import velocity as ref_vel

RANSAC_TRIALS = 20


def build_pipeline(kind: str, cfg, processing, device):
    """The program's frame-batched pipeline with the deployment's parameters."""
    from mmwave_radar_processing_tpu_torch.parallel import (
        build_full_pipeline,
        build_point_cloud_pipeline,
    )

    pc = dict(az_antenna_idxs=tuple(processing["az_antennas"]),
              el_antenna_idxs=tuple(processing["el_antennas"]),
              cfar_params={k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in processing["cfar"].items()},
              max_dets=processing["max_dets"], num_angle_bins=processing["num_angle_bins"],
              shift_az_resp=processing["az_shift"], shift_el_resp=processing["el_shift"])
    if kind == "pointcloud":
        return build_point_cloud_pipeline(cfg, device=device, **pc)
    if kind != "combined":
        raise ValueError(f"unknown pipeline {kind!r}")
    v = processing["velocity"]
    vel = dict(lower_range_bound=v["lower_range_bound"], upper_range_bound=v["upper_range_bound"],
               num_angle_bins=v["num_angle_bins"],
               valid_angle_range=tuple(np.deg2rad(v["valid_angle_deg"])),
               peak_threshold_db=v["peak_threshold_db"], min_r2_threshold=v["min_r2"],
               min_inlier_percent=v["min_inlier_fraction"])
    return build_full_pipeline(cfg, device=device, velocity_kwargs=vel, **pc)


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` of ``n`` frame indices, sorted, drawn from ``seed``; every index when ``k >= n``."""
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def reference_numbers(cell, re, im, alt, draws, points, valid, velocity, fit=None, tf32=False):
    """The check's numbers: the given outputs of frames ``re``/``im`` against the reference's.

    ``velocity`` ``[F, 3]`` and ``fit`` ``[F, 4]`` (R^2 az, el, inlier fraction
    az, el) are compared where given.
    """
    radar, p = cell.radar, cell.config["processing"]
    ref = ref_pc.point_cloud(re, im, radar, p, tf32=tf32)
    nums = compare.cloud_numbers(points, valid, ref.points.cpu().numpy(),
                                 ref.valid.cpu().numpy(), range_res=radar.range_res,
                                 vel_max=radar.vel_max, vel_res=radar.vel_res)
    if velocity is not None:
        rv = ref_vel.velocity(re, im, alt, draws, radar, p, tf32=tf32)
        nums.update(compare.velocity_numbers(velocity, rv.velocity.cpu().numpy(), fit,
                                             None if fit is None else rv.fit.cpu().numpy()))
    return nums


class Run:
    UNITS = {"frames_per_s": "frames/s"}

    def __init__(self, ctx):
        cell = ctx.cell
        self.cell, self.seed, self.device = cell, ctx.seed, ctx.device
        mix = cell.mix
        self.kind, self.n, self.batch = mix["pipeline"], int(mix["frames"]), int(mix["batch"])
        if self.n % self.batch:
            raise ValueError(f"frames {self.n} is not a whole number of batches of {self.batch}")
        self.re, self.im, self.alt = scene.frames(cell.radar, self.n, ctx.seed, ctx.device)
        self.draws = None
        if self.kind == "combined":
            shape = (self.n, 2, RANSAC_TRIALS, cell.radar.loops)
            self.draws = scene.gumbel(shape, scene.draws_seed(ctx.seed), ctx.device)
        self.pipeline = build_pipeline(self.kind, ctx.port_config(), cell.config["processing"],
                                       ctx.device)
        self.call = ctx.program(self.pipeline, self.kind)
        pin = ctx.device.type == "cuda"
        k = cell.config["processing"]["max_dets"]
        self.host = {"points": torch.zeros((self.n, k, 4), pin_memory=pin),
                     "valid": torch.zeros((self.n, k), dtype=torch.bool, pin_memory=pin)}
        if self.kind == "combined":
            self.host["velocity"] = torch.zeros((self.n, 3), pin_memory=pin)
            self.host["fit"] = torch.zeros((self.n, 4), pin_memory=pin)
        with torch.no_grad():
            self._outputs(0)  # the one shape this traffic uses; outputs discarded
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    def _outputs(self, start: int) -> dict:
        s = slice(start, start + self.batch)
        if self.kind == "combined":
            pc, vel = self.call(self.re[s], self.im[s], self.alt[s], gumbel=self.draws[s])
            fit = torch.stack([vel.az_r2, vel.el_r2, vel.az_inlier, vel.el_inlier], dim=-1)
            return {"points": pc.points, "valid": pc.valid, "velocity": vel.velocity, "fit": fit}
        pc = self.call(self.re[s], self.im[s])
        return {"points": pc.points, "valid": pc.valid}

    def window(self, window) -> dict:
        nb = self.n // self.batch
        k = 0
        window.start()
        with torch.no_grad():
            while True:
                start = (k % nb) * self.batch
                with span("pipeline"):
                    out = self._outputs(start)
                with span("copy_out"):
                    for key, value in out.items():
                        self.host[key][start:start + self.batch].copy_(value, non_blocking=True)
                k += 1
                if window.done(self.batch) and k >= nb:
                    break
            with span("sync"):
                wall = window.finish()
        frames = k * self.batch
        return {"frames_per_s": frames / wall, "attempted": frames, "failed": 0}

    def release(self) -> None:
        del self.pipeline, self.call
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self):
        idx = sample(self.n, int(self.cell.spec["sample_frames"]), self.seed)
        sel = torch.as_tensor(idx, device=self.device)
        host = {k: v.numpy()[idx] for k, v in self.host.items()}
        with torch.no_grad():
            nums = reference_numbers(
                self.cell, self.re[sel], self.im[sel], self.alt[sel],
                None if self.draws is None else self.draws[sel], host["points"], host["valid"],
                host.get("velocity"), host.get("fit"))
        return compare.checks(nums, self.cell.spec["limits"])
