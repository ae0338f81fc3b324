"""Synthetic-aperture beamforming over a whole recording (JAX: ``parallel/beamform_pipeline.py``).

The JAX package runs a ``lax.scan`` whose carry is the ring buffer of the
last ``F`` frames and velocities.  Frame ``t``'s buffer holds frames
``t-F+1 ... t``, zero frames and velocities before the start, so here the
recording is padded in front with ``F-1`` zero frames and cut into windows
(``unfold``): every frame's gate, chained geometry and steering phases
``[T, A, E]`` at once, then one batched complex GEMM ``[T, ns, E] @ [T, E,
A]`` and the windowed range DFT.  A zero velocity fails the gate (every
``min_vel`` bound is compared with ``|v|``, and a zero direction has cosine
0), so the first ``F-1`` outputs are zero with ``ok`` False, as in the scan.

The gate and the geometry are ``processors.synthetic_array``'s functions.
No step has a hand-written kernel: the JAX package computes the product as
a plain ``@``.  Precision is full float32 with TF32 off.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.ops import dft, windows
from mmwave_radar_processing_tpu_torch.parallel.pipeline import set_full_fp32
from mmwave_radar_processing_tpu_torch.parallel.spectral_pipeline import check_planes
from mmwave_radar_processing_tpu_torch.processors.base import resolve_device
from mmwave_radar_processing_tpu_torch.processors.synthetic_array import (
    chained_geometry,
    steering_phases,
    velocity_gate,
)


class SyntheticAperturePipeline(nn.Module):
    """``(raw_re, raw_im [T, rx, ns, nc], vels [T, 3]) -> (mag [T, ns, n_az, n_el], ok [T])``.

    The frames are one recording in time order.  Magnitudes are zero where
    the velocity gate rejects the aperture (the reference's empty return).
    Build it with :func:`build_synthetic_aperture_pipeline`.
    """

    def __init__(self, cfg: RadarConfig, *, receiver_idx: int, chirp_cfg_idx: int,
                 num_frames: int, stride: int, az_angle_bins_rad, el_angle_bins_rad,
                 min_vel, max_vel, max_vel_stdev):
        super().__init__()
        self.ns = cfg.num_adc_samples
        self.receiver_idx, self.num_frames = int(receiver_idx), int(num_frames)
        self.frame_shape = (self.ns, cfg.chirps_per_frame)
        self.num_rx = cfg.num_rx_antennas
        az = np.asarray(az_angle_bins_rad, float)
        el = np.asarray(el_angle_bins_rad, float)
        self.n_az, self.n_el = len(az), len(el)
        self.lambda_m = cfg.lambda_m
        self.frame_dt = cfg.frame.periodicity_ms * 1e-3
        self.bounds = tuple(np.asarray(b, float) for b in (min_vel, max_vel, max_vel_stdev))

        chirp_cfg_idxs = np.tile(np.arange(cfg.frame.start_index, cfg.frame.end_index + 1),
                                 cfg.frame.loops)
        valid_idx = np.flatnonzero(chirp_cfg_idxs == chirp_cfg_idx)[::stride]
        self.register_buffer("valid_idx", torch.from_numpy(valid_idx))
        self.register_buffer("chirp_times_s", torch.from_numpy(
            ((np.arange(cfg.chirps_per_frame - 1, -1, -1) * -cfg.chirp_period_us)[valid_idx]
             * 1e-6).astype(np.float32)))
        th, ph = np.meshgrid(az, el, indexing="ij")
        self.register_buffer("steering", torch.from_numpy(np.stack(
            [np.cos(th) * np.cos(ph), np.sin(th) * np.cos(ph), np.sin(ph)],
            axis=-1).reshape(-1, 3).astype(np.float32)))  # (A, 3)
        self.register_buffer("element_window", torch.from_numpy(
            windows.hamming(num_frames * len(valid_idx))))
        self.register_buffer("rng_dft", dft.to_matrix(
            dft.dft_factors(self.ns, window=np.hanning(self.ns))))

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor,
                vels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        check_planes(raw_re, raw_im, frame_shape=self.frame_shape,
                     min_planes=self.receiver_idx + 1, device=self.rng_dft.device)
        t, f = raw_re.shape[0], self.num_frames
        if vels.shape != (t, 3) or not vels.is_floating_point() \
                or vels.device != raw_re.device:
            raise ValueError(f"expected velocities [{t}, 3] on {raw_re.device}, got "
                             f"{vels.dtype} {tuple(vels.shape)} on {vels.device}")
        frames = torch.complex(raw_re[:, self.receiver_idx],
                               raw_im[:, self.receiver_idx])[:, :, self.valid_idx]
        # the ring buffer of every frame: F-1 zero frames in front, then windows
        padded = torch.nn.functional.pad(frames, (0, 0, 0, 0, f - 1, 0))
        adc = padded.unfold(0, f, 1).permute(0, 3, 1, 2)  # [T, F, ns, C]
        vel = torch.nn.functional.pad(vels.to(torch.float32), (0, 0, f - 1, 0))
        vel = vel.unfold(0, f, 1).transpose(1, 2)  # [T, F, 3]

        ok = velocity_gate(vel, *self.bounds)
        geometry = chained_geometry(vel, self.chirp_times_s, self.frame_dt)  # [T, F, 3, C]
        positions = geometry.transpose(1, 2).reshape(t, 3, -1)  # [T, 3, E]
        data = adc.transpose(1, 2).reshape(t, self.ns, -1)  # [T, ns, E]

        phases = steering_phases(self.steering, positions, self.lambda_m)  # [T, A, E]
        beamformed = (data * self.element_window) @ phases.transpose(1, 2)  # [T, ns, A]
        spec = self.rng_dft.transpose(0, 1) @ beamformed
        mag = dft.cabs(spec).reshape(t, self.ns, self.n_az, self.n_el)
        return torch.where(ok[:, None, None, None], mag, 0.0), ok


def build_synthetic_aperture_pipeline(
    cfg: RadarConfig,
    *,
    receiver_idx: int = 0,
    chirp_cfg_idx: int = 0,
    num_frames: int = 3,
    stride: int = 1,
    az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 60)),
    el_angle_bins_rad=np.array([0.0]),
    min_vel=np.array([0.15, 0.0, 0.0]),
    max_vel=np.array([0.3, 0.05, 0.05]),
    max_vel_stdev=np.array([0.1, 0.1, 0.1]),
    device,
) -> SyntheticAperturePipeline:
    """Build ``(raw_re [T, ...], raw_im [T, ...], vels [T, 3]) -> (mag, ok)`` on ``device``.

    The signature mirrors the JAX package's (whose defaults differ from the
    processor's: ``num_frames=3`` here, 2 there).  Calls :func:`set_full_fp32`.
    """
    device = resolve_device(device)
    set_full_fp32()
    return SyntheticAperturePipeline(
        cfg, receiver_idx=receiver_idx, chirp_cfg_idx=chirp_cfg_idx,
        num_frames=num_frames, stride=stride, az_angle_bins_rad=az_angle_bins_rad,
        el_angle_bins_rad=el_angle_bins_rad, min_vel=min_vel, max_vel=max_vel,
        max_vel_stdev=max_vel_stdev).to(device)
