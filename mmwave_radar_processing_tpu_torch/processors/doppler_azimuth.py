"""Doppler-azimuth (velocity-vs-angle) responses and their peak detectors (JAX: ``processors/doppler_azimuth.py``).

The object API of the ADC-domain velocity estimator, frame by frame; the
batched pipeline is ``parallel/velocity_pipeline.py``.  The transforms are
``torch.fft`` calls on the processor's device (XLA FFTs in the JAX package,
no Pallas kernel).  Kept from the JAX package:

- the altitude range window is a mask over the full range axis and a masked
  mean, not a slice of a data-dependent length;
- the precise (zoom FFT) path splits the velocity band into a negative and a
  positive half-band, keeps the aliasing ``+2*vel_max`` shift of the negative
  half and the reference's ``fs*2`` quirk, and always emits the fixed
  ``2*num_vel_bins`` layout with a validity mask (an empty side is masked,
  not dropped);
- row peak picking takes at most one peak a velocity row.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import czt, dft, peaks as peaks_ops, windows
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    as_float32,
    resolve_device,
)

MIN_ROW_PROMINENCE_DB = 4.0


# --------------------------------------------------------------------------- #
# pure functions
# --------------------------------------------------------------------------- #
def window_cube(adc_cube: torch.Tensor, *, angle_window: bool) -> torch.Tensor:
    """Hann windows over the range and chirp axes, and the antenna axis when ``angle_window``.

    Reference ``apply_hanning_windows`` :84-100: the antenna window applies
    for the standard geometry with virtual antennas enabled.
    """
    rx, ns, nc = adc_cube.shape[-3:]
    w = windows.outer_window(windows.hanning(ns), windows.hanning(nc))
    out = adc_cube * torch.from_numpy(w).to(adc_cube.device)
    if angle_window:
        out = out * torch.from_numpy(windows.hanning(rx)).to(adc_cube.device)[:, None, None]
    return out


def _angle_padded(rng_fft: torch.Tensor, num_angle_bins: int) -> torch.Tensor:
    """``[..., rx, range, chirp] -> [..., range, chirp, num_angle_bins]``, antennas zero-padded."""
    data = torch.movedim(rng_fft, -3, -1)
    return torch.nn.functional.pad(data, (0, num_angle_bins - data.shape[-1]))


def coarse_doppler_azimuth(rng_fft: torch.Tensor, *, num_angle_bins: int,
                           shift_angle: bool = True) -> torch.Tensor:
    """Per-range 2D (chirp x antenna) FFT magnitude.

    ``rng_fft``: ``[rx, range, chirp]`` complex range-FFT cube.  Returns
    ``[range, doppler, angle]`` float32; Doppler always fftshifted, angle only
    when ``shift_angle`` (reference :296-334).
    """
    spec = torch.fft.fft2(_angle_padded(rng_fft, num_angle_bins), dim=(-2, -1))
    dims = (-2, -1) if shift_angle else (-2,)
    return torch.abs(torch.fft.fftshift(spec, dim=dims))


def zoom_half_band(data: torch.Tensor, f_start: torch.Tensor, f_stop: torch.Tensor,
                   *, num_samples: int, fs: float) -> torch.Tensor:
    """Zoom FFT over the chirp axis, then the angle FFT (reference ``zoom_fft`` :130-162).

    ``data``: ``[range, chirp, angle_pad]`` complex.  Returns ``[range,
    num_samples, angle_pad]`` float32 magnitudes (no angle shift).
    """
    x = data[:, :num_samples, :]
    # the reference builds its ZoomFFT with fs*2: kept for parity
    zoomed = czt.zoom_fft_dynamic(x, f_start, f_stop, n=num_samples, m=num_samples,
                                  fs=fs * 2.0, axis=1)
    return torch.abs(torch.fft.fft(zoomed, dim=2))


def floor_db(resp_mag: torch.Tensor, min_threshold_db: float = 30.0) -> torch.Tensor:
    """dB with a floor ``max - min_threshold_db`` over the whole map (reference :350-355)."""
    db = dft.db20(torch.abs(resp_mag) + 1e-12)
    return torch.maximum(db, db.max() - min_threshold_db)


def detect_peaks_rows(resp_mag: torch.Tensor, vel_bins: torch.Tensor,
                      valid_angle_bins: torch.Tensor, min_threshold_db: float = 30.0,
                      row_valid: Optional[torch.Tensor] = None):
    """Best prominent (>= 4 dB) peak of each velocity row: ``(angles, vels, valid)``, each ``[rows]``.

    The reference's Nx2 (angle, velocity) list as a fixed-capacity masked set
    (reference :336-384: one best peak a row, rows without one dropped).
    The highest local maximum whose prominence passes, as the dense
    ``argmax(where(local_maxima & (prominences >= 4), row, -inf))`` of the
    JAX package picks it, computed at the candidate peaks only.
    """
    db = floor_db(resp_mag, min_threshold_db)
    best_idx, found = peaks_ops.best_prominent_peak(db, MIN_ROW_PROMINENCE_DB)
    if row_valid is not None:
        found = found & row_valid
    angles = torch.where(found, valid_angle_bins[best_idx], 0.0)
    vels = torch.where(found, vel_bins, 0.0)
    return angles, vels, found


def detect_peak_zero_az(resp_mag: torch.Tensor, vel_bins: torch.Tensor, *,
                        zero_az_col: int, min_threshold_db: float = 30.0,
                        row_valid: Optional[torch.Tensor] = None):
    """Strongest local maximum of the zero-azimuth column: ``(velocity, found)`` scalars.

    Reference :387-415, which returns ``[0, vel]`` or an empty array.
    """
    col = floor_db(resp_mag, min_threshold_db)[:, zero_az_col]
    mask = peaks_ops.local_maxima(col)
    if row_valid is not None:
        mask = mask & row_valid
    best = torch.argmax(torch.where(mask, col, float("-inf")))
    found = mask.any()
    return torch.where(found, vel_bins[best], 0.0), found


# --------------------------------------------------------------------------- #
# processor
# --------------------------------------------------------------------------- #
class DopplerAzimuthProcessor(Processor):
    """Velocity-vs-angle response processor (x forward, y left) on an explicit ``device``."""

    def __init__(
        self,
        config: RadarConfig,
        num_angle_bins: int = 64,
        valid_angle_range: Sequence[float] = (np.deg2rad(-60), np.deg2rad(60)),
        min_zoom_fft_vel_span: float = 0.1,
        *,
        device,
        **kwargs,
    ):
        super().__init__(config)
        config = self.config
        self.device = resolve_device(device)
        self.num_angle_bins = num_angle_bins
        self.min_zoom_fft_vel_span = min_zoom_fft_vel_span
        self.range_bins = grids.range_bins(config, variant="eps")
        self.num_range_bins = config.num_adc_samples
        self.vel_bins = grids.vel_bins(config)
        self.num_vel_bins = self.vel_bins.shape[0]
        self.phase_shifts = grids.phase_shift_bins(num_angle_bins)
        self.angle_bins = grids.angle_bins(num_angle_bins)
        valid_angle_range = np.asarray(valid_angle_range, float)
        self.valid_angle_range = valid_angle_range
        self.valid_angle_mask = (self.angle_bins >= valid_angle_range[0]) & (
            self.angle_bins <= valid_angle_range[1])
        self.valid_angle_bins = self.angle_bins[self.valid_angle_mask]
        self.zero_az_col = int(np.argmin(np.abs(self.valid_angle_bins)))
        self._angle_window = (config.array_geometry == "standard"
                              and config.virtual_antennas_enabled)
        # velocity zoom frequency mapping (reference :146-151)
        self._vel_fs = 1.0 / config.vel_res_m_s
        self._vel_scale = self._vel_fs / config.vel_max_m_s
        self._range_bins_t = as_float32(self.range_bins, self.device)
        self._vel_bins_t = as_float32(self.vel_bins, self.device)
        self._valid_angle_bins_t = as_float32(self.valid_angle_bins, self.device)
        self._valid_cols = torch.from_numpy(np.flatnonzero(self.valid_angle_mask)).to(
            self.device)
        # layout of the fixed zoomed velocity grid: [neg (nv) | pos (nv)]
        self.zoomed_vel_bins: Optional[torch.Tensor] = None
        self.zoomed_vel_valid: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ #
    def _range_mask(self, range_window) -> torch.Tensor:
        bins = self._range_bins_t
        if range_window is None or (hasattr(range_window, "__len__")
                                    and len(range_window) == 0):
            return torch.ones(bins.shape, dtype=torch.bool, device=self.device)
        rw = as_float32(range_window, self.device)
        return (bins >= rw[0]) & (bins <= rw[1])

    def _prepare(self, adc_cube, rx_antennas) -> torch.Tensor:
        cube = as_complex64(adc_cube, self.device)
        if rx_antennas is not None and len(rx_antennas) > 0:
            cube = cube[torch.as_tensor(np.asarray(rx_antennas, int), device=self.device)]
        return torch.fft.fft(window_cube(cube, angle_window=self._angle_window), dim=-2)

    def _zoomed_grid(self, vel_range: torch.Tensor):
        """Fixed-layout zoomed velocity grid and each side's bins and presence.

        ``set_zoomed_fft_vel_bins`` (reference :164-205) with both sides always
        present; an empty side is a mask, not a shape.
        """
        nv = self.num_vel_bins
        v0, v1 = vel_range[0], vel_range[1]
        k = torch.arange(nv, dtype=torch.float32, device=self.device)
        neg_stop = torch.clamp_max(v1, -1e-4)
        neg_bins = v0 + (neg_stop - v0) * k / nv  # endpoint excluded
        pos_start = torch.clamp_min(v0, 1e-4)
        pos_bins = pos_start + (v1 - pos_start) * k / nv
        neg_present, pos_present = v0 <= 0, v1 > 0
        bins = torch.cat([neg_bins, pos_bins])
        valid = torch.cat([neg_present.expand(nv), pos_present.expand(nv)])
        return bins, valid, (neg_bins, neg_present), (pos_bins, pos_present)

    def _clamp_vel_range(self, vel_range: torch.Tensor) -> torch.Tensor:
        """Clamp to ``[-vmax, vmax]`` and widen to the minimum spread (reference :234-246)."""
        vmax = self.config.vel_max_m_s
        v0 = torch.clamp_min(vel_range[0], -vmax)
        v1 = torch.clamp_max(vel_range[1], vmax)
        spread = 2.0 * self.min_zoom_fft_vel_span
        need = (v1 - v0) < spread
        dist_hi = torch.abs(v1 - vmax)
        dist_lo = torch.abs(v0 + vmax)
        v1 = torch.where(need & (dist_hi > dist_lo), v0 + spread, v1)
        v0 = torch.where(need & (dist_lo > dist_hi), v1 - spread, v0)
        return torch.stack([v0, v1])

    def precise_doppler_azimuth(self, rng_fft: torch.Tensor, vel_range,
                                shift_angle: bool = True):
        """Zoom-FFT Doppler-azimuth response over the fixed two-half-band grid.

        Returns ``(resp [range, 2*nv, angle], zoomed_vel_bins [2*nv],
        row_valid [2*nv])``.
        """
        vel_range = self._clamp_vel_range(as_float32(vel_range, self.device))
        bins, valid, (neg_bins, neg_present), (pos_bins, pos_present) = \
            self._zoomed_grid(vel_range)
        nv = self.num_vel_bins
        data = _angle_padded(rng_fft, self.num_angle_bins)
        vmax = self.config.vel_max_m_s
        span = self.min_zoom_fft_vel_span
        scale, fs = self._vel_scale, self._vel_fs

        # negative half: the aliased band (+2*vmax), reference :251-265
        neg_lo, neg_hi = neg_bins.min(), neg_bins.max()
        neg_ok = neg_present & (torch.abs(neg_hi - neg_lo) > span)
        neg_resp = zoom_half_band(data, (neg_lo + 2 * vmax) * scale,
                                  (neg_hi + 2 * vmax) * scale, num_samples=nv, fs=fs)
        neg_resp = torch.where(neg_ok, neg_resp, 0.0)

        pos_lo, pos_hi = pos_bins.min(), pos_bins.max()
        pos_ok = pos_present & (torch.abs(pos_hi - pos_lo) > span)
        pos_resp = zoom_half_band(data, pos_lo * scale, pos_hi * scale,
                                  num_samples=nv, fs=fs)
        pos_resp = torch.where(pos_ok, pos_resp, 0.0)

        resp = torch.cat([neg_resp, pos_resp], dim=1)  # [range, 2nv, angle]
        if shift_angle:
            resp = torch.fft.fftshift(resp, dim=2)
        row_valid = torch.cat([neg_ok.expand(nv), pos_ok.expand(nv)]) & valid
        return resp, bins, row_valid

    def _range_average(self, resp: torch.Tensor, rmask: torch.Tensor) -> torch.Tensor:
        resp = resp[..., self._valid_cols]
        return (resp * rmask[:, None, None]).sum(dim=0) / torch.clamp_min(rmask.sum(), 1)

    # ------------------------------------------------------------------ #
    def process(
        self,
        adc_cube,
        rx_antennas: Optional[Sequence[int]] = None,
        range_window=None,
        shift_angle: bool = True,
        use_precise_fft: bool = False,
        precise_vel_range=(-0.25, 0.25),
        **kwargs,
    ):
        """Doppler-azimuth response averaged over the range window (reference ``process`` :419-491).

        Returns the ``[vel, valid_angle]`` response tensor for the coarse
        path, or ``(resp, zoomed_vel_bins, row_valid)`` for the precise one.
        """
        rng_fft = self._prepare(adc_cube, rx_antennas)
        rmask = self._range_mask(range_window)
        if not use_precise_fft:
            resp = coarse_doppler_azimuth(rng_fft, num_angle_bins=self.num_angle_bins,
                                          shift_angle=shift_angle)
            return self._range_average(resp, rmask)
        resp, bins, row_valid = self.precise_doppler_azimuth(
            rng_fft, precise_vel_range, shift_angle=shift_angle)
        self.zoomed_vel_bins, self.zoomed_vel_valid = bins, row_valid
        return self._range_average(resp, rmask), bins, row_valid

    # peak detectors (reference-compatible wrappers) -------------------- #
    def detect_peaks_rows(self, resp_mag, vel_bins, min_threshold_dB=30.0, row_valid=None):
        return detect_peaks_rows(resp_mag, as_float32(vel_bins, self.device),
                                 self._valid_angle_bins_t, min_threshold_dB, row_valid)

    def detect_peak_zero_az(self, resp_mag, vel_bins, min_threshold_dB=30.0,
                            row_valid=None):
        return detect_peak_zero_az(resp_mag, as_float32(vel_bins, self.device),
                                   zero_az_col=self.zero_az_col,
                                   min_threshold_db=min_threshold_dB, row_valid=row_valid)
