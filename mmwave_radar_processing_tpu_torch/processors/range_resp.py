"""Range FFT processing: coarse profile, zoom (chirp-z) refinement, peaks (JAX: ``processors/range_resp.py``).

- ``coarse_fft``: Hann window -> FFT along samples -> magnitude -> mean over
  RX;
- ``zoom_fft``: a Bluestein chirp-z transform over a range band.  Band edges
  given as Python numbers use factors built once on the host and kept on the
  device; edges given as tensors (a band that follows the data, as the
  altimeter's does) build the factors on the device;
- ``find_peaks``: the strongest prominent peaks, as fixed-capacity outputs.

Inputs may be numpy arrays or tensors of any complex width; they are taken
to complex64 on the processor's device.  Outputs are tensors on that device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import czt, peaks as peaks_ops
from mmwave_radar_processing_tpu_torch.ops.windows import hanning
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    resolve_device,
)


def hann_window(n: int, device) -> torch.Tensor:
    """The float32 symmetric Hann window of length ``n`` on ``device``."""
    return torch.from_numpy(hanning(n)).to(device)


def coarse_range_fft(adc_frame: torch.Tensor,
                     window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Windowed range FFT magnitude averaged over RX.

    Args:
        adc_frame: ``[..., rx, samples]`` complex64 (one chirp already selected).
        window: the Hann window of that length on the frame's device; built
            when not given.

    Returns:
        ``[..., samples]`` float32 magnitude range profile.
    """
    if window is None:
        window = hann_window(adc_frame.shape[-1], adc_frame.device)
    spec = torch.fft.fft(adc_frame * window, dim=-1)
    return torch.abs(spec).mean(dim=-2)


def linspace(start, stop, num: int, device) -> torch.Tensor:
    """``num`` float32 samples from ``start`` to ``stop`` inclusive; tensors or numbers.

    ``start*(1-t) + stop*t`` with ``t = i/(num-1)``, the last sample set to
    ``stop``: the formula of ``jnp.linspace``.
    """
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return start.reshape(1)
    t = torch.arange(num, dtype=torch.float32, device=device) / (num - 1)
    out = start * (1.0 - t) + stop * t
    out[-1] = stop
    return out


class RangeProcessor(Processor):
    """Range-profile processor (coarse + zoom FFT + peak finding)."""

    def __init__(self, config: RadarConfig, *, device, **kwargs):
        super().__init__(config)
        config = self.config
        self.device = resolve_device(device)
        self.num_range_bins = config.num_adc_samples
        self.range_bins = grids.range_bins(config, variant="plain")
        # zoom-FFT frequency mapping of the reference
        self._zoom_fs = 1.0 / config.range_res_m
        self._zoom_scale = self._zoom_fs / config.range_max_m
        self._window = hann_window(self.num_range_bins, self.device)
        self._range_bins_t = self._to_device(self.range_bins)
        #: static zoom bands seen so far: (m, f1, f2) -> factor tensors
        self._czt_factors = {}

    def _to_device(self, grid: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(grid, np.float32)).to(self.device)

    def _chirp(self, adc_cube, chirp_idx: int) -> torch.Tensor:
        """Chirp ``chirp_idx`` of ``[..., rx, samples, chirps]`` on the device."""
        return as_complex64(adc_cube, self.device)[..., :, :, chirp_idx]

    # ------------------------------------------------------------------ #
    def coarse_fft(self, adc_cube, chirp_idx: int = 0) -> torch.Tensor:
        """Coarse range profile from one chirp of ``[rx, samples, chirps]``."""
        return coarse_range_fft(self._chirp(adc_cube, chirp_idx), self._window)

    def static_czt_factors(self, m: int, f1: float, f2: float):
        """Bluestein factor tensors of the static band ``[f1, f2)``, built once."""
        key = (m, f1, f2)
        if key not in self._czt_factors:
            host = czt.czt_factors(self.num_range_bins, m, f1, f2, self._zoom_fs)
            self._czt_factors[key] = tuple(
                torch.from_numpy(f).to(self.device) for f in host[:3])
        return self._czt_factors[key]

    def zoom_fft(self, adc_cube, range_start_m, range_stop_m, chirp_idx: int = 0,
                 num_bins: Optional[int] = None):
        """High-resolution zoom over ``[range_start_m, range_stop_m]``.

        Returns ``(zoom_magnitude, zoom_range_bins)``.  Band edges are Python
        numbers (a static band) or scalar tensors (a band computed on the
        device).
        """
        n = self.num_range_bins
        m = num_bins or n
        x = self._chirp(adc_cube, chirp_idx) * self._window
        f1 = range_start_m * self._zoom_scale
        f2 = range_stop_m * self._zoom_scale
        if isinstance(range_start_m, (int, float)) and isinstance(range_stop_m, (int, float)):
            f1, f2 = float(f1), float(f2)
            spec = czt.zoom_fft(x, n=n, m=m, f1=f1, f2=f2, fs=self._zoom_fs,
                                factors=self.static_czt_factors(m, f1, f2))
        else:
            spec = czt.zoom_fft_dynamic(x, f1, f2, n=n, m=m, fs=self._zoom_fs)
        mag = torch.abs(spec).mean(dim=-2)
        return mag, linspace(range_start_m, range_stop_m, m, self.device)

    def find_peaks(self, rng_resp_db: torch.Tensor, rng_bins: torch.Tensor,
                   max_peaks: int = 3, threshold_dB: float = 20.0):
        """Strongest prominent peaks of a dB range profile.

        Returns ``(peak_ranges_m, peak_vals_db, valid)``, each
        ``[..., max_peaks]``; consume through ``valid``.
        """
        idx, vals, valid = peaks_ops.top_peaks_within_threshold(
            rng_resp_db, max_peaks=max_peaks, min_prominence=6.0,
            threshold_db=threshold_dB)
        return torch.where(valid, rng_bins[idx], 0.0), vals, valid

    def process(self, adc_cube, chirp_idx: int = 0, **kwargs) -> torch.Tensor:
        """Coarse range profile."""
        return self.coarse_fft(adc_cube, chirp_idx)
