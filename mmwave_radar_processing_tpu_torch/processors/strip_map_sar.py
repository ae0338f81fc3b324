"""Doppler-domain strip-map SAR for linear platform motion (JAX: ``processors/strip_map_sar.py``).

One windowless 2D FFT over ``[sample, chirp]`` of a single RX on the
processor's device, with the synthetic element spacing ``d_rx = 2 * Tc * v``
recomputed from the platform velocity each frame.  The velocity-dependent
valid range/angle crop is host numpy in float64, as in the reference (its
bounds depend on the run-time velocity, so it changes the output's shape).

Reference quirk kept for parity: the angle grid is
``arcsin(phase_shifts * lambda) / (2*pi*d_rx)``, the ``arcsin`` applied
*before* the division by ``2*pi*d_rx`` (``strip_map_SAR_processor.py:119-121``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    resolve_device,
)
from mmwave_radar_processing_tpu_torch.processors.virtual_array import (
    VirtualArrayReformatter,
)


def strip_map_fft(rx_slice: torch.Tensor) -> torch.Tensor:
    """Full 2D FFT of ``[..., sample, chirp]`` with the Doppler fftshift (reference :181-189)."""
    return torch.fft.fftshift(torch.fft.fft2(rx_slice, dim=(-2, -1)), dim=-1)


class StripMapSARProcessor(Processor):
    """Strip-map SAR processor (reference-compatible API) on an explicit ``device``."""

    def __init__(self, config: RadarConfig,
                 az_angle_range_rad=np.deg2rad(np.array([-30.0, 30.0])), *, device,
                 **kwargs):
        super().__init__(config)
        config = self.config
        self.device = resolve_device(device)
        self.az_angle_range_rad = np.asarray(az_angle_range_rad, float)
        if config.virtual_antennas_enabled:
            self.virtual_array_reformatter = VirtualArrayReformatter(config,
                                                                     device=self.device)

        self.num_range_bins = config.num_adc_samples
        self.range_bins = np.linspace(0, config.range_max_m, self.num_range_bins)
        self.lambda_m = config.lambda_m
        self.chirps_per_frame = config.chirps_per_frame
        self.chirp_period_us = config.chirp_period_us
        self.phase_shifts = np.linspace(np.pi, -np.pi, config.frame.loops)

        # per-frame geometry (velocity dependent)
        self.angle_bins_rad: Optional[np.ndarray] = None
        self.valid_ranges_slice: Optional[slice] = None
        self.valid_angles_slice: Optional[slice] = None
        self.ground_range_bins: Optional[np.ndarray] = None
        self.ground_az_bins_rad: Optional[np.ndarray] = None
        self.thetas = self.rhos = self.x_s = self.y_s = None

    def configure_array_geometry(self, vel_m_per_s: float, sensor_height_m: float,
                                 max_SAR_distance: float) -> None:
        """Recompute the synthetic-array bins for the current velocity (reference :112-160)."""
        d_rx = 2.0 * self.chirp_period_us * 1e-6 * vel_m_per_s
        self.angle_bins_rad = np.arcsin(self.phase_shifts * self.lambda_m) / (
            2 * np.pi * d_rx)
        min_angle_idx = np.argmin(
            np.abs(self.angle_bins_rad - np.min(self.az_angle_range_rad)))
        max_angle_idx = np.argmin(
            np.abs(self.angle_bins_rad - np.max(self.az_angle_range_rad)))
        self.valid_angles_slice = slice(min(min_angle_idx, max_angle_idx),
                                        max(min_angle_idx, max_angle_idx))
        self.ground_az_bins_rad = self.angle_bins_rad[self.valid_angles_slice]

        min_rng_idx = np.nonzero(self.range_bins > sensor_height_m)[0][0]
        max_rng_idx = np.nonzero(self.range_bins < max_SAR_distance)[0][-1]
        self.valid_ranges_slice = slice(min_rng_idx, max_rng_idx)
        self.ground_range_bins = np.sqrt(
            self.range_bins[self.valid_ranges_slice] ** 2 - d_rx**2)

        self.thetas, self.rhos = np.meshgrid(self.ground_az_bins_rad,
                                             self.ground_range_bins, indexing="xy")
        self.x_s = self.rhos * np.cos(self.thetas)
        self.y_s = self.rhos * np.sin(self.thetas)

    def process(self, adc_cube, vel_m_per_s: float, sensor_height_m: float = 0.24,
                rx_index: int = 0, max_SAR_distance: float = 1.5,
                **kwargs) -> np.ndarray:
        """Cropped complex64 strip-map SAR image ``[ground_range, ground_angle]`` on the host."""
        if self.config.virtual_antennas_enabled:
            cube = self.virtual_array_reformatter.process(adc_cube)
        else:
            cube = as_complex64(adc_cube, self.device)
        self.configure_array_geometry(vel_m_per_s, sensor_height_m, max_SAR_distance)
        response = strip_map_fft(cube[..., rx_index, :, :]).cpu().numpy()
        return response[..., self.valid_ranges_slice, self.valid_angles_slice]
