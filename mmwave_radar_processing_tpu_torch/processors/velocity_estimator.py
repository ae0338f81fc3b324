"""ADC-domain ego-velocity estimation from Doppler-azimuth responses (JAX: ``processors/velocity_estimator.py``).

The object API, frame by frame; the batched ODS path is
``parallel/velocity_pipeline.py``, which imports the sub-array constants
below.  Per frame the estimator:

1. builds the azimuth (and, for the ODS geometry, elevation) Doppler-azimuth
   responses over an altitude-centred range window with the geometry's
   antenna sub-arrays (ODS: two 4-antenna sub-arrays averaged; standard: the
   8- or 4-element line; reference :169-259);
2. reads ``vx`` off the zero-azimuth Doppler peak (reference :640-661);
3. optionally computes both responses again with a zoom FFT centred at
   ``-vx`` and reads ``vx`` again (reference :831-847);
4. fits ``vd = -vx cos(theta) - vy sin(theta)`` to the per-row (angle,
   velocity) peaks with RANSAC: the standard model for ``vx >= 0.1``, the
   inverted small-``vx`` model otherwise (reference :346-506);
5. gates the proposed estimate on R^2 and inlier-fraction thresholds
   (reference :597-638).

The ODS output order is ``[az_vy, el_vy, vx]``.  The responses run on the
estimator's device; the peak lists and the estimates live on the host, as in
the JAX package.  RANSAC samples with Gumbel scores from a CPU
``torch.Generator`` seeded with ``seed`` (so an estimator on a GPU and one on
the CPU draw the same), all drawn in :meth:`VelocityEstimator._draw_scores`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.ops import ransac
from mmwave_radar_processing_tpu_torch.processors.doppler_azimuth import (
    DopplerAzimuthProcessor,
)

# antenna subsets per geometry (reference velocity_estimator.py:169-259), as
# virtual channel indices (v = cfg*num_rx + rx) where virtual antennas are on
ODS_AZ_SETS_VIRTUAL = ([0, 3, 4, 7], [1, 2, 5, 6])
ODS_AZ_SETS_PLAIN = ([0, 3], [1, 2])
ODS_EL_SETS_VIRTUAL = ([10, 11, 6, 7], [9, 8, 5, 4])
ODS_EL_SETS_PLAIN = ([1, 0], [3, 4])

MAX_TRIALS = 20
MIN_SAMPLES = 10


def _given(x) -> bool:
    """A non-empty input: a tensor or anything numpy takes."""
    if x is None:
        return False
    return (x.numel() if isinstance(x, torch.Tensor) else np.size(x)) > 0


def _host(x) -> np.ndarray:
    """A point cloud (tensor on any device, or array-like) as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class VelocityEstimator(DopplerAzimuthProcessor):
    """Ego-velocity estimator over Doppler-azimuth responses (x forward, y left)."""

    def __init__(
        self,
        config: RadarConfig,
        lower_range_bound: float,
        upper_range_bound: float,
        precise_vel_bound: float = 0.25,
        valid_angle_range: Sequence[float] = (np.deg2rad(-70), np.deg2rad(70)),
        peak_threshold_dB: float = 30.0,
        x_measurement_only: bool = False,
        min_R2_threshold: float = 0.6,
        min_inlier_percent: float = 0.75,
        seed: int = 42,
        vy_mode: str = "adc",
        *,
        device,
        **kwargs,
    ):
        """``vy_mode`` (beyond the reference):

        - ``"adc"`` (default): vy from the RANSAC row-peak fit of the
          Doppler-azimuth response (reference ``velocity_estimator.py:663-692``).
        - ``"hybrid_points"`` (standard geometry only): the ADC zero-azimuth
          ``vx``, and ``vy`` from a 1D RANSAC of the point cloud with ``vx``
          held fixed (``-vel - u_x*vx = u_y*vy``, threshold 0.15, 20 trials,
          10 samples).  ``process`` then needs both ``adc_cube`` and
          ``points``.
        """
        super().__init__(config, num_angle_bins=64,
                         valid_angle_range=np.asarray(valid_angle_range), device=device)
        self.lower_range_bound = lower_range_bound
        self.upper_range_bound = upper_range_bound
        self.precise_vel_bound = precise_vel_bound
        self.peak_threshold_dB = peak_threshold_dB
        self.x_measurement_only = x_measurement_only
        self.min_R2_threshold = min_R2_threshold
        self.min_inlier_percent = min_inlier_percent
        if vy_mode not in ("adc", "hybrid_points"):
            raise ValueError(f"unknown vy_mode {vy_mode!r}")
        if vy_mode == "hybrid_points" and self.config.array_geometry != "standard":
            raise ValueError("vy_mode='hybrid_points' is standard-geometry "
                             "only (the ODS path estimates vy per sub-array)")
        self.vy_mode = vy_mode
        self.seed = seed
        self._generator = torch.Generator().manual_seed(seed)

        # latest responses and peaks (reference-compatible attribute surface)
        self.azimuth_response_mag = None
        self.elevation_response_mag = None
        self.precise_azimuth_response_mag = None
        self.precise_elevation_response_mag = None
        self.azimuth_peaks = np.empty((0, 2))
        self.elevation_peaks = np.empty((0, 2))
        self.azimuth_peak_zero_az = np.empty(0)
        self.elevation_peak_zero_az = np.empty(0)

        self.ego_vx_estimate = -1.0
        # which input the last frame came from, for the standard-geometry
        # gate: the reference tells the points path by the sign test
        # ``ego_vx_estimate < 0`` (:623), which mis-gates a genuine negative
        # ADC vx.  True before the first frame, as no ADC cube was seen.
        self._points_path = True
        self.azimuth_ego_vy_estimate = 0.0
        self.azimuth_estimate_R2 = 0.0
        self.azimuth_inlier_percent = 0.0
        self.elevation_ego_vy_estimate = 0.0
        self.elevation_estimate_R2 = 0.0
        self.elevation_inlier_percent = 0.0
        self.proposed_velocity_estimate = np.empty(0)
        self.current_velocity_estimate = np.array([0.0, 0.0, 0.0])
        self.history_R2_statistics = []
        self.history_inlier_statistics = []

    # ------------------------------------------------------------------ #
    def get_range_window(self, altitude: float = 0.0, sensing_direction: str = "down"):
        """Altitude-centred range window (reference :129-153)."""
        if sensing_direction == "down":
            return np.array([
                max(0.0, altitude - self.lower_range_bound),
                min(self.config.range_max_m, altitude + self.upper_range_bound),
            ])
        return np.array([1.0, self.config.range_max_m])

    def _subset_response(self, adc_cube, rx_sets, range_window, shift_angle,
                         use_precise, center_vel):
        """The mean of the Doppler-azimuth responses of the given antenna subsets."""
        precise_range = np.array([center_vel - self.precise_vel_bound,
                                  center_vel + self.precise_vel_bound])
        resps, bins, row_valid = [], None, None
        for rx in rx_sets:
            out = super().process(adc_cube, rx_antennas=rx, range_window=range_window,
                                  shift_angle=shift_angle, use_precise_fft=use_precise,
                                  precise_vel_range=precise_range)
            if use_precise:
                resp, bins, row_valid = out
            else:
                resp = out
            resps.append(resp)
        return sum(resps) / len(resps), bins, row_valid

    def _az_sets(self):
        if self.config.array_geometry == "ods":
            return (ODS_AZ_SETS_VIRTUAL if self.config.virtual_antennas_enabled
                    else ODS_AZ_SETS_PLAIN)
        n = 8 if self.config.virtual_antennas_enabled else 4
        return (list(range(n)),)

    def _el_sets(self):
        if self.config.array_geometry != "ods":
            raise NotImplementedError("Elevation response requires the ODS array geometry.")
        return (ODS_EL_SETS_VIRTUAL if self.config.virtual_antennas_enabled
                else ODS_EL_SETS_PLAIN)

    def compute_azimuth_response(self, adc_cube, range_window, use_precise_fft=False,
                                 precise_fft_center_vel=0.0):
        resp, bins, row_valid = self._subset_response(
            adc_cube, self._az_sets(), range_window, True, use_precise_fft,
            precise_fft_center_vel)
        if use_precise_fft:
            self.precise_azimuth_response_mag = resp
            self.zoomed_vel_bins, self.zoomed_vel_valid = bins, row_valid
        else:
            self.azimuth_response_mag = resp

    def compute_elevation_response(self, adc_cube, range_window, use_precise_fft=False,
                                   precise_fft_center_vel=0.0):
        resp, bins, row_valid = self._subset_response(
            adc_cube, self._el_sets(), range_window, False, use_precise_fft,
            precise_fft_center_vel)
        if use_precise_fft:
            self.precise_elevation_response_mag = resp
            self.zoomed_vel_bins, self.zoomed_vel_valid = bins, row_valid
        else:
            self.elevation_response_mag = resp

    # ------------------------------------------------------------------ #
    def _bins_for(self, precise: bool):
        if precise:
            return self.zoomed_vel_bins, self.zoomed_vel_valid
        return self._vel_bins_t, None

    def _peaks_for(self, resp, precise: bool) -> np.ndarray:
        bins, row_valid = self._bins_for(precise)
        angles, vels, valid = self.detect_peaks_rows(
            resp, bins, min_threshold_dB=self.peak_threshold_dB, row_valid=row_valid)
        valid = valid.cpu().numpy()
        return np.stack([angles.cpu().numpy()[valid], vels.cpu().numpy()[valid]], axis=1)

    def _zero_az_for(self, resp, precise: bool) -> np.ndarray:
        bins, row_valid = self._bins_for(precise)
        vel, found = self.detect_peak_zero_az(
            resp, bins, min_threshold_dB=self.peak_threshold_dB, row_valid=row_valid)
        return np.array([0.0, float(vel)]) if bool(found) else np.empty(0)

    def _responses(self, use_precise_response: bool):
        if use_precise_response:
            return self.precise_azimuth_response_mag, self.precise_elevation_response_mag
        return self.azimuth_response_mag, self.elevation_response_mag

    def detect_vel_row_peaks(self, use_precise_response=False):
        az, el = self._responses(use_precise_response)
        if az is not None:
            self.azimuth_peaks = self._peaks_for(az, use_precise_response)
        if el is not None:
            self.elevation_peaks = self._peaks_for(el, use_precise_response)

    def detect_vel_zero_az_peaks(self, use_precise_response=False):
        az, el = self._responses(use_precise_response)
        if az is not None:
            self.azimuth_peak_zero_az = self._zero_az_for(az, use_precise_response)
        if el is not None:
            self.elevation_peak_zero_az = self._zero_az_for(el, use_precise_response)

    def estimate_ego_vx_velocity(self) -> float:
        """vx from the zero-azimuth peaks: ``-mean`` of the sides found (reference :640-661)."""
        az, el = self.azimuth_peak_zero_az, self.elevation_peak_zero_az
        if az.shape[0] > 0 and el.shape[0] > 0:
            self.ego_vx_estimate = -0.5 * (az[1] + el[1])
        elif az.shape[0] > 0:
            self.ego_vx_estimate = -az[1]
        elif el.shape[0] > 0:
            self.ego_vx_estimate = -el[1]
        else:
            self.ego_vx_estimate = 0.0
        return self.ego_vx_estimate

    # RANSAC fits ------------------------------------------------------- #
    def _draw_scores(self, n: int, trials: int = MAX_TRIALS) -> torch.Tensor:
        """Gumbel scores ``float32 [trials, n]`` of one RANSAC fit; every fit draws here.

        Drawn on the CPU from the seeded generator, then moved to the device.
        A test may replace this method to hand in another stream's draws.
        """
        return ransac.gumbel((trials, n), self._generator).to(self.device)

    def _ransac(self, h: np.ndarray, y: np.ndarray, valid: np.ndarray,
                threshold: float) -> ransac.RansacResult:
        """One RANSAC fit of host arrays on the device (float32, as the JAX package casts them)."""
        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        return ransac.ransac_linear(
            dev(h), dev(y), dev(valid, torch.bool), min_samples=MIN_SAMPLES,
            residual_threshold=threshold, max_trials=MAX_TRIALS,
            scores=self._draw_scores(len(y)))

    def lsq_fit_ego_vy_ransac(self, peaks: np.ndarray):
        if self.ego_vx_estimate >= 0.1:
            return self.lsq_fit_ego_vy_ransac_standard(peaks)
        return self.lsq_fit_ego_vy_ransac_small_vx(peaks)

    def lsq_fit_ego_vy_ransac_standard(self, peaks: np.ndarray):
        """``-vd - vx cos(theta) = vy sin(theta)`` RANSAC fit (reference :409-455)."""
        if peaks is None or len(peaks) == 0:
            return 0.0, 0.0, 0.0
        y = -peaks[:, 1] - self.ego_vx_estimate * np.cos(peaks[:, 0])
        h = np.sin(peaks[:, 0])[:, None]
        res = self._ransac(h, y, np.ones(len(y), bool), 0.15)
        return float(res.coef[0]), float(res.r2), float(res.inlier_fraction)

    def lsq_fit_ego_vy_ransac_small_vx(self, peaks: np.ndarray):
        """Inverted small-vx model ``theta = -(1/vy)(vd - vx)`` (reference :457-506)."""
        if peaks is None or len(peaks) == 0:
            return 0.0, 0.0, 0.0
        y = peaks[:, 0]
        h = (peaks[:, 1] - self.ego_vx_estimate)[:, None]
        res = self._ransac(h, y, np.ones(len(y), bool), 0.20)
        a = float(res.coef[0])
        ego_vy = -1.0 / a if (bool(res.ok) and a != 0.0) else 0.0
        return ego_vy, float(res.r2), float(res.inlier_fraction)

    def lsq_fit_ego_vel_ransac_points(self, points: np.ndarray):
        """2D points fit ``-vel = (p/|p|) . v`` (reference :361-407)."""
        if points.shape[0] == 0:
            return np.zeros(2), 0.0, 0.0
        y = -points[:, 3]
        h = points[:, 0:2] / np.linalg.norm(points[:, 0:2], axis=1, keepdims=True)
        res = self._ransac(h, y, np.ones(len(y), bool), 0.15)
        return res.coef.cpu().numpy(), float(res.r2), float(res.inlier_fraction)

    def lsq_fit_ego_vy_ransac_points_fixed_vx(self, points: np.ndarray, vx: float):
        """Hybrid vy: a 1D points RANSAC with the ADC vx held fixed.

        ``vel = -(u . v)`` with ``u = p_2d/|p_2d|`` gives ``-vel - u_x*vx =
        u_y*vy``.  Zero rows of a padded point cloud (zero norm) are masked
        out, not divided by their norm.
        """
        if points.shape[0] == 0:
            return 0.0, 0.0, 0.0
        norms = np.linalg.norm(points[:, 0:2], axis=1)
        live = norms > 0.0
        u = points[:, 0:2] / np.where(norms, norms, 1.0)[:, None]
        y = np.where(live, -points[:, 3] - u[:, 0] * vx, 0.0)
        res = self._ransac(u[:, 1:2], y, live, 0.15)
        return float(res.coef[0]), float(res.r2), float(res.inlier_fraction)

    def lsq_predict_velocity_measurement(self, v, angles_to_predict=None):
        """Predicted vd per angle for an ego velocity ``[vx, vy]`` (reference :536-554)."""
        if angles_to_predict is None or np.size(angles_to_predict) == 0:
            angles_to_predict = self.valid_angle_bins
        h = np.stack([np.cos(angles_to_predict), np.sin(angles_to_predict)], axis=-1)
        return -h @ np.asarray(v)

    # estimate assembly and gating --------------------------------------- #
    def estimate_ego_velocity_adc_data(self):
        if self.x_measurement_only:
            self.proposed_velocity_estimate = np.array([self.ego_vx_estimate])
            return
        if self.azimuth_peaks.shape[0] > 0:
            (self.azimuth_ego_vy_estimate, self.azimuth_estimate_R2,
             self.azimuth_inlier_percent) = self.lsq_fit_ego_vy_ransac(self.azimuth_peaks)
        if self.elevation_peaks.shape[0] > 0:
            (self.elevation_ego_vy_estimate, self.elevation_estimate_R2,
             self.elevation_inlier_percent) = self.lsq_fit_ego_vy_ransac(
                self.elevation_peaks)
        if self.config.array_geometry == "ods":
            self.proposed_velocity_estimate = np.array([
                self.azimuth_ego_vy_estimate, self.elevation_ego_vy_estimate,
                self.ego_vx_estimate])
        else:
            self.proposed_velocity_estimate = np.array(
                [self.ego_vx_estimate, self.azimuth_ego_vy_estimate, 0.0])

    def estimate_ego_velocity_points(self, points: np.ndarray):
        if self.config.array_geometry != "standard":
            raise NotImplementedError(
                "points-based estimation is standard-geometry only (ref :694-721)")
        vel_est, self.azimuth_estimate_R2, self.azimuth_inlier_percent = (
            self.lsq_fit_ego_vel_ransac_points(points))
        if self.x_measurement_only:
            self.proposed_velocity_estimate = np.array([vel_est[0]])
        else:
            self.proposed_velocity_estimate = np.array([vel_est[0], vel_est[1], 0.0])

    def update_and_check_current_vel_measurements(self):
        """R^2 and inlier gates per axis (reference :597-638).

        Intentional divergence: the standard geometry's gate tells the points
        path by the ``_points_path`` flag of the last input, not by the
        reference's sign test ``ego_vx_estimate < 0.0`` (:623), which zeroes
        a genuine negative ADC vx as if it came from a failed points fit.
        """
        if self.x_measurement_only:
            self.current_velocity_estimate[0] = self.proposed_velocity_estimate[0]
            return
        if self.config.array_geometry == "ods":
            if (self.azimuth_estimate_R2 >= self.min_R2_threshold
                    and self.azimuth_inlier_percent >= self.min_inlier_percent):
                self.current_velocity_estimate[0] = self.proposed_velocity_estimate[0]
            else:
                self.current_velocity_estimate[0] = 0.0
            if (self.elevation_estimate_R2 >= self.min_R2_threshold
                    and self.elevation_inlier_percent >= self.min_inlier_percent):
                self.current_velocity_estimate[1] = self.proposed_velocity_estimate[1]
            else:
                self.current_velocity_estimate[1] = 0.0
            self.current_velocity_estimate[2] = self.proposed_velocity_estimate[2]
        elif self._points_path:
            if self.azimuth_estimate_R2 >= self.min_R2_threshold:
                self.current_velocity_estimate = self.proposed_velocity_estimate.copy()
            else:
                self.current_velocity_estimate = np.zeros(3)
        else:
            if self.azimuth_estimate_R2 >= self.min_R2_threshold:
                self.current_velocity_estimate[1] = self.proposed_velocity_estimate[1]
            else:
                self.current_velocity_estimate[1] = 0.0
            self.current_velocity_estimate[0] = self.proposed_velocity_estimate[0]
            self.current_velocity_estimate[2] = 0.0

    def update_history(self, estimated=None, ground_truth=None):
        self.history_R2_statistics.append(
            np.array([self.azimuth_estimate_R2, self.elevation_estimate_R2]))
        self.history_inlier_statistics.append(
            np.array([self.azimuth_inlier_percent, self.elevation_inlier_percent]))
        super().update_history(estimated, ground_truth)

    # ------------------------------------------------------------------ #
    def process(self, adc_cube=None, points: Optional[np.ndarray] = None,
                altitude: float = 0.0, enable_precise_responses: bool = False,
                **kwargs) -> np.ndarray:
        """Velocity estimate (reference ``process`` :785-866); ODS order ``[az_vy, el_vy, vx]``."""
        if _given(adc_cube):
            self._points_path = False
            range_window = self.get_range_window(
                altitude=altitude, sensing_direction=self.config.array_direction)
            ods = self.config.array_geometry == "ods"
            self.compute_azimuth_response(adc_cube, range_window)
            if ods:
                self.compute_elevation_response(adc_cube, range_window)
            self.detect_vel_zero_az_peaks(use_precise_response=False)
            self.estimate_ego_vx_velocity()

            if enable_precise_responses:
                center = -self.ego_vx_estimate
                self.compute_azimuth_response(adc_cube, range_window, use_precise_fft=True,
                                              precise_fft_center_vel=center)
                if ods:
                    self.compute_elevation_response(
                        adc_cube, range_window, use_precise_fft=True,
                        precise_fft_center_vel=center)
                self.detect_vel_zero_az_peaks(use_precise_response=True)
                self.estimate_ego_vx_velocity()

            if not self.x_measurement_only:
                self.detect_vel_row_peaks(use_precise_response=enable_precise_responses)
            self.estimate_ego_velocity_adc_data()
            if (self.vy_mode == "hybrid_points" and _given(points)
                    and not self.x_measurement_only):
                # the vx-constrained points fit replaces the row-peak vy; the
                # standard-geometry gate then R^2-gates vy and keeps vx
                (self.azimuth_ego_vy_estimate, self.azimuth_estimate_R2,
                 self.azimuth_inlier_percent) = self.lsq_fit_ego_vy_ransac_points_fixed_vx(
                    _host(points), float(self.ego_vx_estimate))
                self.proposed_velocity_estimate = np.array(
                    [self.ego_vx_estimate, self.azimuth_ego_vy_estimate, 0.0])
        elif _given(points):
            self._points_path = True
            self.estimate_ego_velocity_points(_host(points))

        self.update_and_check_current_vel_measurements()
        return self.current_velocity_estimate

    def reset(self):
        self.history_R2_statistics = []
        self.history_inlier_statistics = []
        super().reset()
