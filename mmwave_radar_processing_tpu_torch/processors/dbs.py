"""Doppler beam sharpening (DBS) enhanced range-angle processing (JAX: ``processors/dbs.py``).

A Hann-windowed 3D FFT (range, then shifted Doppler, then the zero-padded,
shifted angle axis), and per output angle the Doppler bin that matches the
expected ground Doppler ``vd = -r_hat . v`` at that look angle, gathered in
one indexing op.  The low-speed fallback to the plain range-angle response
is a host branch in the object API: the gate compares a run-time velocity
with a fixed threshold, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import windows
from mmwave_radar_processing_tpu_torch.processors.base import as_complex64, as_float32
from mmwave_radar_processing_tpu_torch.processors.range_angle import RangeAngleProcessor


def _hann(m: int, device) -> torch.Tensor:
    return torch.from_numpy(windows.hanning(m)).to(device)


def windowed_3d_fft(adc_cube: torch.Tensor, *, num_angle_bins: int) -> torch.Tensor:
    """Hann-windowed 3D FFT ``[..., rx, ns, nc] -> [..., angle, range, doppler]`` (reference :137-198).

    The range FFT along samples, the shifted Doppler FFT along chirps, then
    an angle window over the *input* antennas, zero padding to
    ``num_angle_bins`` and a shifted FFT along the antenna axis.
    """
    rx, ns, nc = adc_cube.shape[-3:]
    dev = adc_cube.device
    rng_resp = torch.fft.fft(adc_cube * _hann(ns, dev)[:, None], dim=-2)
    rng_dop = torch.fft.fftshift(torch.fft.fft(rng_resp * _hann(nc, dev), dim=-1), dim=-1)
    padded = torch.nn.functional.pad(rng_dop * _hann(rx, dev)[:, None, None],
                                     (0, 0, 0, 0, 0, num_angle_bins - rx))
    return torch.fft.fftshift(torch.fft.fft(padded, dim=-3), dim=-3)


def dbs_sharpen(angle_rng_dop_mag: torch.Tensor, velocity_ned: torch.Tensor,
                dbs_angle_bins: torch.Tensor, coarse_angle_bins: torch.Tensor,
                vel_bins: torch.Tensor) -> torch.Tensor:
    """``resp[nearest coarse angle, :, nearest Doppler bin]`` per DBS angle: ``[range, dbs_angle]``.

    Reference :200-263.  All float32 on the device, in the JAX package's
    order of operations: the expected Doppler ``-(r_hat @ v[:2])`` and its
    nearest bin are computed there too, since a float64 host computation
    picks other bins at midpoints.
    """
    r_hat = torch.stack([torch.cos(dbs_angle_bins), torch.sin(dbs_angle_bins)], dim=1)
    dop_vel = -(r_hat @ velocity_ned[:2])
    vel_idx = torch.argmin(torch.abs(vel_bins[None, :] - dop_vel[:, None]), dim=1)
    ang_idx = torch.argmin(torch.abs(coarse_angle_bins[None, :] - dbs_angle_bins[:, None]),
                           dim=1)
    return angle_rng_dop_mag[ang_idx, :, vel_idx].transpose(0, 1)


class RangeAngleProcessorDBSEnhanced(RangeAngleProcessor):
    """Range-angle heatmap with Doppler beam sharpening above a speed gate, on an explicit ``device``."""

    def __init__(self, config: RadarConfig, num_angle_bins_range_angle_response: int = 64,
                 num_angle_bins_dbs_enhanced_response: int = 64,
                 min_x_y_vel_dbs: float = 0.25, *, device, **kwargs):
        super().__init__(config, num_angle_bins=num_angle_bins_range_angle_response,
                         device=device)
        self.num_angle_bins_dbs_enhanced_response = num_angle_bins_dbs_enhanced_response
        self.min_vel_dbs = min_x_y_vel_dbs
        self.vel_bins = grids.vel_bins(self.config)
        self.angle_bins_no_dbs_enhancement = self.angle_bins.copy()
        self.angle_bins_dbs_enhanced = np.linspace(
            self.angle_bins_no_dbs_enhancement[0], self.angle_bins_no_dbs_enhancement[-1],
            num_angle_bins_dbs_enhanced_response)
        self._grids_t = tuple(as_float32(g, self.device) for g in (
            self.angle_bins_dbs_enhanced, self.angle_bins_no_dbs_enhancement,
            self.vel_bins))
        self.compute_mesh_grid()

    # mesh switching (reference :91-109)
    def compute_mesh_grid(self) -> None:
        self.angle_bins = self.angle_bins_no_dbs_enhancement
        self.thetas, self.rhos, self.x_s, self.y_s = grids.polar_mesh(
            self.range_bins, self.angle_bins)

    def compute_mesh_grid_dbs_enhanced(self) -> None:
        self.angle_bins = self.angle_bins_dbs_enhanced
        self.thetas, self.rhos, self.x_s, self.y_s = grids.polar_mesh(
            self.range_bins, self.angle_bins)

    def get_dop_vel(self, angle: float, ego_vel: np.ndarray) -> float:
        """Expected ground Doppler at a look angle (reference :200-214)."""
        r = np.array([np.cos(angle), np.sin(angle), 0.0])
        return float(-(r / np.linalg.norm(r)) @ np.asarray(ego_vel))

    def process_no_dbs(self, adc_cube, chirp_idx=0, rx_antennas=None, **kwargs):
        self.compute_mesh_grid()
        return super().process(adc_cube, chirp_idx=chirp_idx, rx_antennas=rx_antennas,
                               **kwargs)

    def process_dbs_enhanced(self, adc_cube, velocity_ned,
                             rx_antennas: Optional[Sequence[int]] = None, **kwargs):
        """DBS-sharpened ``[range, dbs_angle]`` response (reference :318-342)."""
        self.compute_mesh_grid_dbs_enhanced()
        cube = as_complex64(adc_cube, self.device)
        if rx_antennas is not None and len(rx_antennas) > 0:
            cube = cube[torch.as_tensor(np.asarray(rx_antennas, int), device=self.device)]
        mag = torch.abs(windowed_3d_fft(cube, num_angle_bins=self.num_angle_bins))
        return dbs_sharpen(mag, as_float32(velocity_ned, self.device), *self._grids_t)

    def process(self, adc_cube, velocity_ned, rx_antennas: Optional[Sequence[int]] = None,
                chirp_idx: int = 0, **kwargs):
        """DBS when moving fast enough, the plain range-angle response otherwise."""
        velocity_ned = np.asarray(velocity_ned, float)
        if np.linalg.norm(velocity_ned[0:2]) < self.min_vel_dbs:
            return self.process_no_dbs(adc_cube, chirp_idx=chirp_idx,
                                       rx_antennas=rx_antennas, **kwargs)
        return self.process_dbs_enhanced(adc_cube, velocity_ned, rx_antennas=rx_antennas,
                                         **kwargs)
