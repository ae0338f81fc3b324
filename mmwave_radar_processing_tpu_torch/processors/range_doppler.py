"""Range-Doppler map: separable Hann windows + 2D FFT + Doppler fftshift (JAX: ``processors/range_doppler.py``).

The ``[rx, sample, chirp]`` cube is transformed for all RX at once; the
detectors need the full complex cube, and selecting one antenna afterwards
is free.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops.windows import hanning
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    resolve_device,
)


def hann_window_2d(ns: int, nc: int, device) -> torch.Tensor:
    """The float32 outer product of the range and Doppler Hann windows on ``device``."""
    return torch.from_numpy(np.multiply.outer(hanning(ns), hanning(nc))).to(device)


def range_doppler_map(adc_cube: torch.Tensor, *,
                      window: Union[bool, torch.Tensor] = True) -> torch.Tensor:
    """Complex range-Doppler cube for all RX.

    Args:
        adc_cube: ``[..., rx, samples, chirps]`` complex64.
        window: as in the JAX package, ``True`` applies the 2D Hann window and
            ``False`` none; a ``[samples, chirps]`` tensor on the cube's
            device is applied as given (the processor passes its cached
            Hann window).

    Returns:
        ``[..., rx, samples, chirps]`` complex64, Doppler axis fftshifted
        (zero velocity centered).
    """
    if window is True:
        window = hann_window_2d(*adc_cube.shape[-2:], adc_cube.device)
    if window is not False:
        adc_cube = adc_cube * window
    spec = torch.fft.fft2(adc_cube, dim=(-2, -1))
    return torch.fft.fftshift(spec, dim=-1)


class RangeDopplerProcessor(Processor):
    """Range-Doppler response processor (reference-compatible API)."""

    def __init__(self, config: RadarConfig, *, device, **kwargs):
        super().__init__(config)
        config = self.config
        self.device = resolve_device(device)
        self.range_bins = grids.range_bins(config, variant="eps")
        self.vel_bins = grids.vel_bins(config)
        self._range_bins_t = self._to_device(self.range_bins)
        self._vel_bins_t = self._to_device(self.vel_bins)
        #: 2D windows by (samples, chirps): raw and reformatted cubes differ
        self._rd_windows = {}

    def _to_device(self, grid: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(grid, np.float32)).to(self.device)

    def range_doppler(self, adc_cube) -> torch.Tensor:
        """The complex range-Doppler cube of a cube given as numpy or a tensor."""
        cube = as_complex64(adc_cube, self.device)
        shape = tuple(cube.shape[-2:])
        if shape not in self._rd_windows:
            self._rd_windows[shape] = hann_window_2d(*shape, self.device)
        return range_doppler_map(cube, window=self._rd_windows[shape])

    def process(self, adc_cube, rx_idx: int = 0, return_magnitude: bool = True,
                **kwargs) -> torch.Tensor:
        """Range-Doppler response.

        ``rx_idx >= 0`` selects one antenna, ``-1`` returns all;
        ``return_magnitude`` toggles ``abs``.
        """
        resp = self.range_doppler(adc_cube)
        if return_magnitude:
            resp = torch.abs(resp)
        if rx_idx >= 0:
            resp = resp[..., rx_idx, :, :]
        return resp
