"""Range-azimuth heatmap: windowed 2D FFT over (sample, antenna) (JAX: ``processors/range_angle.py``).

Antenna selection and the zero padding to ``num_angle_bins`` are plain
tensor ops; the transform is one ``torch.fft.fft2``.  The angle grid is the
reference's ``arcsin(delta_phi/pi)`` convention of ``config.grids``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import windows
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    resolve_device,
)


def range_angle_map(chirp_slice: torch.Tensor, *, num_angle_bins: int,
                    window: bool = True) -> torch.Tensor:
    """Range-azimuth magnitude map from one chirp.

    Args:
        chirp_slice: ``[..., rx, samples]`` complex64 (antennas already selected).

    Returns:
        ``[..., samples, num_angle_bins]`` float32 magnitude; the angle axis
        is fftshifted, the range axis is not (reference :104-120).
    """
    rx, ns = chirp_slice.shape[-2:]
    if window:
        w = windows.outer_window(windows.hanning(rx), windows.hanning(ns))
        chirp_slice = chirp_slice * torch.from_numpy(w).to(chirp_slice.device)
    data = torch.nn.functional.pad(chirp_slice.transpose(-1, -2),
                                   (0, num_angle_bins - rx))
    resp = torch.fft.fftshift(torch.fft.fft2(data, dim=(-2, -1)), dim=-1)
    return torch.abs(resp)


class RangeAngleProcessor(Processor):
    """Range-azimuth heatmap processor (reference-compatible API) on an explicit ``device``."""

    def __init__(self, config: RadarConfig, num_angle_bins: int = 64, *, device,
                 **kwargs):
        super().__init__(config)
        self.device = resolve_device(device)
        self.num_angle_bins = num_angle_bins
        self.num_range_bins = self.config.num_adc_samples
        self.range_bins = grids.range_bins(self.config, variant="offset")
        self.phase_shifts = grids.phase_shift_bins(num_angle_bins)
        self.angle_bins = grids.angle_bins(num_angle_bins)
        self.thetas, self.rhos, self.x_s, self.y_s = grids.polar_mesh(
            self.range_bins, self.angle_bins)

    def process(self, adc_cube, chirp_idx: int = 0,
                rx_antennas: Optional[Sequence[int]] = None,
                perform_windowing: bool = True, **kwargs) -> torch.Tensor:
        """Range-azimuth response ``[range_bins, angle_bins]`` (reference :68-122).

        ``adc_cube``: ``[..., n_virtual, ns, loops]``, numpy or a tensor.  The
        Hann window goes over the *full* antenna axis before ``rx_antennas``
        selects antennas, as in the reference; an empty ``rx_antennas``
        means all antennas.
        """
        cube = as_complex64(adc_cube, self.device)
        if perform_windowing:
            rx, ns = cube.shape[-3:-1]
            w = windows.outer_window(windows.hanning(rx), windows.hanning(ns))
            cube = cube * torch.from_numpy(w).to(self.device)[..., None]
        if rx_antennas is not None and len(rx_antennas) > 0:
            idx = torch.as_tensor(np.asarray(rx_antennas, dtype=int), device=self.device)
            cube = cube[..., idx, :, :]
        return range_angle_map(cube[..., chirp_idx], num_angle_bins=self.num_angle_bins,
                               window=False)
