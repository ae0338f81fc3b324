"""Altimeter: tracked height above ground from the range profile (JAX: ``processors/altimeter.py``).

The frame-to-frame tracked altitude is an explicit scalar state threaded
through :meth:`Altimeter.step`; the state stays on the processor's device.
The zoom-FFT refinement around the tracked peak builds its chirp factors on
the device from the peak's range.  Where the JAX package branches with
``lax.cond`` on whether a ground peak was found, this per-frame object API
branches in Python: one read of a device scalar, and so one synchronisation
with the host, per frame in precise mode.  ``scan`` is a Python loop over
frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.ops import peaks as peaks_ops
from mmwave_radar_processing_tpu_torch.processors.base import as_complex64
from mmwave_radar_processing_tpu_torch.processors.range_resp import (
    RangeProcessor,
    coarse_range_fft,
)


class AltimeterState(NamedTuple):
    altitude_measured_m: torch.Tensor  # () float32, radar-measured altitude


class Altimeter(RangeProcessor):
    """Stateful ground-range tracker (coarse peaks + zoom refinement).

    Among prominent coarse peaks, the lowest peak that is above
    ``min_altitude_m`` and within ``altitude_search_limit_m`` of the previous
    estimate is the ground; the optional precise pass re-estimates it with a
    zoom FFT in a ``+-zoom_search_region_m`` window; ``range_bias`` is added
    to the output.
    """

    def __init__(
        self,
        config: RadarConfig,
        min_altitude_m: float,
        zoom_search_region_m: float,
        altitude_search_limit_m: float,
        range_bias: float = 0.0,
        *,
        device,
        **kwargs,
    ):
        super().__init__(config, device=device)
        self.min_altitude_m = float(min_altitude_m)
        self.zoom_search_region_m = float(zoom_search_region_m)
        self.altitude_search_limit_m = float(altitude_search_limit_m)
        self.range_bias = float(range_bias)
        self.state = self.init_state()
        self.coarse_fft_data = None

    def init_state(self, altitude_m=None) -> AltimeterState:
        """The tracker's start: ``min_altitude_m``, or ``altitude_m`` (a number or numpy scalar)."""
        start = self.min_altitude_m if altitude_m is None else float(altitude_m)
        return AltimeterState(torch.tensor(start, dtype=torch.float32,
                                           device=self.device))

    # ------------------------------------------------------------------ #
    def _find_ground_peak(self, peak_ranges, peak_valid, current):
        """Lowest valid peak within the tracking gate, else -1."""
        ok = (
            peak_valid
            & (peak_ranges >= self.min_altitude_m)
            & (torch.abs(peak_ranges - current) <= self.altitude_search_limit_m)
        )
        gp = torch.where(ok, peak_ranges, float("inf")).amin()
        return torch.where(torch.isfinite(gp), gp, -1.0)

    def _peak_ranges(self, mag: torch.Tensor, bins: torch.Tensor, max_peaks: int):
        db = 20.0 * torch.log10(mag + 1e-12)
        idx, _, valid = peaks_ops.top_peaks_within_threshold(
            db, max_peaks=max_peaks, min_prominence=6.0, threshold_db=20.0)
        return torch.where(valid, bins[idx], 0.0), valid

    def _refine(self, cube: torch.Tensor, ground_peak, current):
        lo = torch.clamp_min(ground_peak - self.zoom_search_region_m, 1e-6)
        hi = torch.clamp_max(ground_peak + self.zoom_search_region_m,
                             float(np.max(self.range_bins)) - 1e-6)
        zoom_mag, zoom_bins = self.zoom_fft(cube, lo, hi, chirp_idx=0)
        zranges, zvalid = self._peak_ranges(zoom_mag, zoom_bins, max_peaks=2)
        refined = self._find_ground_peak(zranges, zvalid, current)
        return torch.where(refined > 0, refined, current)

    def step(self, state: AltimeterState, adc_cube, precise_est_enabled: bool = True):
        """``(state, frame) -> (state, corrected_altitude_m)``."""
        cube = as_complex64(adc_cube, self.device)
        current = state.altitude_measured_m
        coarse = coarse_range_fft(cube[..., :, :, 0], self._window)
        peak_ranges, valid = self._peak_ranges(coarse, self._range_bins_t, max_peaks=3)
        ground_peak = self._find_ground_peak(peak_ranges, valid, current)

        if not precise_est_enabled:
            measured = torch.where(ground_peak >= 0, ground_peak, current)
        elif bool(ground_peak >= 0):  # the host reads one device scalar here
            measured = self._refine(cube, ground_peak, current)
        else:
            measured = current
        return AltimeterState(measured), measured + self.range_bias

    def scan(self, adc_frames, precise_est_enabled: bool = True):
        """Process ``[frames, rx, samples, chirps]`` from a fresh state, frame by frame.

        Returns ``(final_state, corrected_altitudes [frames])``.
        """
        frames = as_complex64(adc_frames, self.device)
        state, track = self.init_state(), []
        for frame in frames:
            state, corrected = self.step(state, frame, precise_est_enabled)
            track.append(corrected)
        return state, torch.stack(track)

    # reference-compatible mutating API -------------------------------- #
    @property
    def current_altitude_measured_m(self) -> float:
        return float(self.state.altitude_measured_m)

    @property
    def current_altitude_corrected_m(self) -> float:
        return float(self.state.altitude_measured_m) + self.range_bias

    def process(self, adc_cube, precise_est_enabled: bool = True, **kwargs):
        cube = as_complex64(adc_cube, self.device)
        self.coarse_fft_data = coarse_range_fft(cube[..., :, :, 0], self._window)
        self.state, corrected = self.step(self.state, cube, precise_est_enabled)
        return corrected

    def reset(self) -> None:
        self.state = self.init_state()
        super().reset()
