"""Multi-frame synthetic-aperture beamformer with self-calibration (JAX: ``processors/synthetic_array.py``).

The whole beamformer is one complex product and a batched FFT:

    phases[A, E]   = exp(j*2*pi * (D[A, 3] @ P[3, E]) / lambda)   (A = az*el)
    beamformed     = (data[ns, E] * hamming[E]) @ phases.T        (one matmul)
    response       = FFT(hann[ns] * beamformed, axis=0)

The per-frame element positions, the velocity consistency gate and the phase
self-calibration are plain functions over an explicit ring-buffer state
(:class:`SyntheticArrayState`).  The gate and the geometry take any leading
batch axes, which the batched pipeline (``parallel/beamform_pipeline.py``)
uses for a whole recording at once.

Component map to the reference
(``simple_synthetic_array_beamformer_processor_multiFrame.py``):

- velocity gate             ``_update_vel_history``            (:332-375)
- backward-chained geometry ``_update_array_geometries``       (:377-471)
- steering vectors          ``_compute_beam_stearing_vectors`` (:474-488)
- beamforming               ``compute_synthetic_response``     (:499-585)
- array factor              ``compute_synthetic_array_pattern`` (:615-670)
- self-calibration          ``perform_array_calibration``      (:673-816)
- cartesian resampling      ``get_interpolated_response_cart`` (:587-613),
  as precomputed bilinear weights in place of ``scipy.griddata``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.ops import dft, peaks as peaks_ops, windows
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    as_float32,
    resolve_device,
)


class SyntheticArrayState(NamedTuple):
    """Ring buffers carried across frames (newest at index -1)."""

    adc_history: torch.Tensor  # (num_frames, ns, n_valid_chirps) complex64
    vel_history: torch.Tensor  # (num_frames, 3) float32


class CalibrationTargets(NamedTuple):
    """The reflectors the self-calibration steers at."""

    rng_idx: torch.Tensor  # (3,) int64: the strongest range peaks of the mean spectrum
    az_idx: torch.Tensor  # (3,) int64: each one's strongest azimuth peak
    ok: torch.Tensor  # bool []: three range peaks, and an azimuth peak in each row


def steering_phases(steering: torch.Tensor, positions: torch.Tensor,
                    lambda_m: float) -> torch.Tensor:
    """``exp(j*2*pi*(steering @ positions)/lambda)``: ``(A, 3) x [..., 3, E] -> [..., A, E]`` complex64.

    The angles are scaled in place and the unit modulus is a broadcast
    scalar, so a batch of phases holds the float32 angles and the result
    and nothing more.
    """
    phase = steering @ positions
    phase.mul_(2 * np.pi).div_(lambda_m)
    return torch.polar(torch.ones((), dtype=phase.dtype, device=phase.device), phase)


def beamform(data: torch.Tensor, positions: torch.Tensor, steering: torch.Tensor,
             lambda_m: float, range_window: torch.Tensor,
             element_window: torch.Tensor) -> torch.Tensor:
    """Beamformed range response for every steering angle: ``(ns, A)`` complex64.

    Args:
        data: ``(ns, E)`` complex64, flattened ``[sample, frames*chirps]``.
        positions: ``(3, E)`` float32 synthetic element positions (m).
        steering: ``(A, 3)`` float32 unit steering vectors.
        range_window: ``(ns,)``; element_window: ``(E,)`` float32.

    The element sum is one complex matmul, the range FFT batches over angles:
    the reference's per-angle ``FFT(hann * sum_e(data_e * exp(j*2pi*(d.p_e)/lambda)))``.
    """
    phases = steering_phases(steering, positions, lambda_m)
    beamformed = (data * element_window[None, :]) @ phases.transpose(-1, -2)
    return torch.fft.fft(beamformed * range_window[:, None], dim=0)


def depth_map(mag: torch.Tensor, floor_db: float = 40.0):
    """The plotter's depth map of magnitudes ``[..., range, D]`` over ``D`` directions.

    Returns ``(depth_bin, peak)``, both ``[..., D]``: each direction's
    strongest range bin (the first on ties, as ``np.argmax``) and its
    magnitude.  ``depth_bin`` is -1 where ``20*log10(peak + 1e-12)`` lies more
    than ``floor_db`` below the largest such value over the directions: the
    floor of ``PlotterSyntheticArrayData.plot_depth_map``, in its float32
    order.
    """
    peak, depth_bin = torch.max(mag, dim=-2)
    db = 20 * torch.log10(peak + 1e-12)
    keep = db >= db.amax(dim=-1, keepdim=True) - floor_db
    return torch.where(keep, depth_bin, -1), peak


def velocity_gate(vel_history: torch.Tensor, min_vel, max_vel, max_vel_stdev) -> torch.Tensor:
    """Velocity-consistency gate over ``[..., F, 3]`` histories -> bool ``[...]`` (reference :332-375).

    Every history row within the bounds (absolute values), each axis'
    population standard deviation (``ddof=0``, as ``jnp.std``) under its
    threshold, and every pairwise direction cosine above 0.95.  The bounds
    are float32, as the JAX package casts them.
    """
    dev = vel_history.device
    lo, hi, sd = (as_float32(b, dev) for b in (min_vel, max_vel, max_vel_stdev))
    mag = torch.abs(vel_history)
    within = ((lo <= mag) & (mag <= hi)).flatten(-2).all(-1)
    stdev_ok = (torch.std(vel_history, dim=-2, correction=0) <= sd).all(-1)
    norm = torch.sqrt((vel_history * vel_history).sum(-1, keepdim=True))
    dirs = vel_history / (norm + 1e-6)
    direction_ok = ((dirs @ dirs.transpose(-1, -2)) > 0.95).flatten(-2).all(-1)
    return within & stdev_ok & direction_ok


def chained_geometry(vel_history: torch.Tensor, chirp_times_s: torch.Tensor,
                     frame_dt_s: float) -> torch.Tensor:
    """Backward-chained per-frame synthetic element positions ``[..., F, 3]`` -> ``[..., F, 3, C]``.

    Frame ``f``'s elements sit at ``2 * t_chirp * v_f + pose_f``, the poses
    chained backward from the newest frame at the origin:
    ``pose_{f-1} = pose_f - 2 * v_f * T_frame`` (reference :377-471).
    """
    deltas = -2.0 * vel_history * frame_dt_s
    suffix = torch.flip(torch.cumsum(torch.flip(deltas, (-2,)), dim=-2), (-2,))
    poses = torch.cat([suffix[..., 1:, :], torch.zeros_like(suffix[..., :1, :])], dim=-2)
    return 2.0 * chirp_times_s * vel_history[..., None] + poses[..., None]


def array_factor_pattern(positions: torch.Tensor, steering: torch.Tensor,
                         lambda_m: float) -> torch.Tensor:
    """``|sum_e exp(j*2pi*(d.p_e)/lambda)|`` per angle, normalized to its maximum (reference :615-670)."""
    pattern = torch.abs(steering_phases(steering, positions, lambda_m).sum(dim=1))
    return pattern / pattern.max()


def unwrap(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``np.unwrap(p, axis=dim)``: jumps above pi become their 2*pi complement.

    numpy's rule (discontinuity pi, period 2*pi): each step ``d`` is brought
    into ``[-pi, pi)``, a step of exactly ``-pi`` after the reduction of a
    positive ``d`` becomes ``+pi``, steps under pi in size are left alone,
    and the corrections accumulate along ``dim``.
    """
    p = torch.movedim(p, dim, -1)
    d = torch.diff(p, dim=-1)
    # numpy's and JAX's float modulus: the exact fmod, moved to the divisor's
    # sign (torch.remainder's a - b*floor(a/b) rounds differently)
    ddmod = torch.fmod(d + np.pi, 2 * np.pi)
    ddmod = torch.where(ddmod < 0, ddmod + 2 * np.pi, ddmod) - np.pi
    ddmod = torch.where((ddmod == -np.pi) & (d > 0), np.pi, ddmod)
    correct = torch.where(torch.abs(d) < np.pi, 0.0, ddmod - d)
    out = torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(correct, dim=-1)], dim=-1)
    return torch.movedim(out, -1, dim)


class SyntheticArrayBeamformerProcessor(Processor):
    """Coherent multi-frame synthetic-aperture beamformer with calibration, on an explicit ``device``."""

    def __init__(
        self,
        config: RadarConfig,
        receiver_idx: int = 0,
        chirp_cfg_idx: int = 0,
        num_frames: int = 2,
        stride: int = 1,
        az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 60)),
        el_angle_bins_rad=np.array([0.0]),
        min_vel=np.array([0.17, 0.0, 0.0]),
        max_vel=np.array([0.25, 0.05, 0.05]),
        max_vel_stdev=np.array([0.1, 0.1, 0.1]),
        enable_calibration: bool = False,
        num_calibration_iters: int = 1,
        interpolated_grid_resolution_m: float = 0.1,
        *,
        device,
        **kwargs,
    ):
        super().__init__(config)
        config = self.config
        self.device = resolve_device(device)
        self.receiver_idx = receiver_idx
        self.chirp_cfg_idx = chirp_cfg_idx
        self.num_frames = num_frames
        self.stride = stride
        self.az_angle_bins_rad = np.asarray(az_angle_bins_rad, float)
        self.el_angle_bins_rad = np.asarray(el_angle_bins_rad, float)
        self.min_vel = np.asarray(min_vel, float)
        self.max_vel = np.asarray(max_vel, float)
        self.max_vel_stdev = np.asarray(max_vel_stdev, float)
        self.enable_calibration = enable_calibration
        self.num_calibration_iters = num_calibration_iters
        self.interpolated_grid_resolution_m = interpolated_grid_resolution_m

        # static radar parameters (reference :175-246)
        self.num_range_bins = config.num_adc_samples
        self.range_bins = np.linspace(0, config.range_max_m, self.num_range_bins)
        self.lambda_m = config.lambda_m
        self.chirps_per_frame = config.chirps_per_frame
        self.chirp_period_us = config.chirp_period_us
        self.frame_period_ms = config.frame.periodicity_ms

        chirp_cfg_idxs = np.tile(
            np.arange(config.frame.start_index, config.frame.end_index + 1),
            config.frame.loops)
        valid = chirp_cfg_idxs == chirp_cfg_idx
        valid_idx = np.flatnonzero(valid)[::self.stride]
        self.valid_chirps_mask = np.zeros_like(valid)
        self.valid_chirps_mask[valid_idx] = True
        self.n_valid_chirps = int(self.valid_chirps_mask.sum())
        self._valid_idx_t = torch.from_numpy(
            np.flatnonzero(self.valid_chirps_mask)).to(self.device)

        # chirp start times counted backward from the frame's end (ref :226-234)
        all_starts = np.arange(self.chirps_per_frame - 1, -1, -1) * -self.chirp_period_us
        self.chirp_start_times_us = all_starts[self.valid_chirps_mask]

        # steering grid and meshes (reference :248-288, :474-488)
        self.rhos, self.thetas, self.phis = np.meshgrid(
            self.range_bins, self.az_angle_bins_rad, self.el_angle_bins_rad, indexing="ij")
        self.x_s = self.rhos * np.cos(self.thetas) * np.cos(self.phis)
        self.y_s = self.rhos * np.sin(self.thetas) * np.cos(self.phis)
        self.z_s = self.rhos * np.sin(self.phis)

        th, ph = np.meshgrid(self.az_angle_bins_rad, self.el_angle_bins_rad, indexing="ij")
        self.d = np.array([np.cos(th) * np.cos(ph), np.sin(th) * np.cos(ph), np.sin(ph)])
        self._steering_flat = self.d.reshape(3, -1).T  # (A, 3)

        self._element_window = windows.hamming(self.num_frames * self.n_valid_chirps)
        self._range_window = windows.hanning(self.num_range_bins)
        self._steering_t = as_float32(self._steering_flat, self.device)
        self._element_window_t = as_float32(self._element_window, self.device)
        self._range_window_t = as_float32(self._range_window, self.device)
        self._chirp_times_t = as_float32(self.chirp_start_times_us * 1e-6, self.device)
        self._init_interp_grid()

        # mutable object-API state
        self.state = self.init_state()
        self.array_geometry = np.empty(0)
        self.array_geometry_calibrated = np.empty(0)
        self.array_geometry_valid = False
        self.beamformed_resp = np.zeros(
            (self.num_range_bins, len(self.az_angle_bins_rad), len(self.el_angle_bins_rad)),
            complex)
        self.interpolated_beamformed_resp = np.empty(0)

    def init_state(self) -> SyntheticArrayState:
        return SyntheticArrayState(
            adc_history=torch.zeros((self.num_frames, self.num_range_bins,
                                     self.n_valid_chirps), dtype=torch.complex64,
                                    device=self.device),
            vel_history=torch.zeros((self.num_frames, 3), dtype=torch.float32,
                                    device=self.device))

    def state_from_jax(self, adc_history: np.ndarray,
                       vel_history: np.ndarray) -> SyntheticArrayState:
        """Ring buffers given as numpy (e.g. a JAX processor's state), on this device."""
        want = self.init_state()
        state = SyntheticArrayState(as_complex64(adc_history, self.device),
                                    as_float32(vel_history, self.device))
        for got, ref in zip(state, want):
            if got.shape != ref.shape:
                raise ValueError(f"state shape {tuple(got.shape)}, expected {tuple(ref.shape)}")
        return state

    def _init_interp_grid(self):
        """Bilinear polar -> cartesian resampling weights (host numpy).

        In place of ``scipy.griddata`` (reference :587-613): the azimuth slice
        at elevation index 0 lies on a (range, az) polar grid; each cartesian
        output pixel maps back to fractional (range, az) coordinates, sampled
        with bilinear weights.  Pixels outside the grid are 0 (griddata's
        fill value).
        """
        x = self.x_s[:, :, 0]
        y = self.y_s[:, :, 0]
        res = self.interpolated_grid_resolution_m
        x_lin = np.arange(x.min(), x.max(), res)
        y_lin = np.arange(y.min(), y.max(), res)
        self.interp_x_s, self.interp_y_s = np.meshgrid(x_lin, y_lin, indexing="ij")
        rr = np.hypot(self.interp_x_s, self.interp_y_s)
        th = np.arctan2(self.interp_y_s, self.interp_x_s)

        rmax = self.range_bins[-1]
        nr = self.num_range_bins
        r_frac = rr / max(rmax, 1e-9) * (nr - 1)
        az = self.az_angle_bins_rad
        a_frac = np.interp(th, az, np.arange(len(az)), left=-1, right=-1)
        in_grid = (r_frac <= nr - 1) & (a_frac >= 0)
        # np.interp clamps: reject angles outside the azimuth span as well
        in_grid &= (th >= az.min()) & (th <= az.max())
        r0 = np.clip(np.floor(r_frac).astype(int), 0, nr - 2)
        a0 = np.clip(np.floor(a_frac).astype(int), 0, len(az) - 2)
        self._interp = dict(r0=r0, a0=a0, wr=np.clip(r_frac - r0, 0, 1),
                            wa=np.clip(a_frac - a0, 0, 1), mask=in_grid)

    # geometry
    def update_vel_history(self, vel_history: torch.Tensor) -> torch.Tensor:
        """Velocity-consistency gate (reference ``_update_vel_history`` :332-375)."""
        return velocity_gate(vel_history, self.min_vel, self.max_vel, self.max_vel_stdev)

    def compute_array_geometry(self, vel_history: torch.Tensor) -> torch.Tensor:
        """Backward-chained per-frame element positions ``(F, 3, C)`` (reference :377-471)."""
        return chained_geometry(vel_history, self._chirp_times_t, self.frame_period_ms * 1e-3)

    # beamforming
    def _flatten(self, state: SyntheticArrayState, geometry: torch.Tensor):
        data = state.adc_history.permute(1, 0, 2).reshape(self.num_range_bins, -1)
        positions = geometry.permute(1, 0, 2).reshape(3, -1)
        return data, positions

    def compute_synthetic_response(self, state: SyntheticArrayState,
                                   geometry: torch.Tensor) -> torch.Tensor:
        """Beamformed ``[range, az, el]`` complex64 response."""
        data, positions = self._flatten(state, geometry)
        resp = beamform(data, positions, self._steering_t, self.lambda_m,
                        self._range_window_t, self._element_window_t)
        return resp.reshape(self.num_range_bins, len(self.az_angle_bins_rad),
                            len(self.el_angle_bins_rad))

    def compute_synthetic_array_pattern(self, array_geometry) -> np.ndarray:
        geometry = as_float32(array_geometry, self.device)
        positions = geometry.permute(1, 0, 2).reshape(3, -1)
        pattern = array_factor_pattern(positions, self._steering_t, self.lambda_m)
        return pattern.cpu().numpy().reshape(len(self.az_angle_bins_rad),
                                             len(self.el_angle_bins_rad))

    # calibration
    def _calibration_spectrum(self, state: SyntheticArrayState, geometry: torch.Tensor):
        """The windowed range FFT of every element, ``(ns, E)``, and the element positions ``(3, E)``."""
        data, positions = self._flatten(state, geometry)
        return torch.fft.fft(data * self._element_window_t[None, :], dim=0), positions

    def calibration_targets(self, state: SyntheticArrayState, geometry: torch.Tensor,
                            beamformed: torch.Tensor) -> CalibrationTargets:
        """The reflectors :meth:`perform_array_calibration` steers at (reference :673-740).

        The three strongest local maxima of the mean range spectrum (dB), and
        in each one's azimuth row of the beamformed map the strongest local
        maximum.  These are comparisons of float32 values: at the flat top
        of a broad beam, neighbouring azimuth bins tie to within rounding,
        and another rounding of the same inputs may pick another bin.
        """
        freq, _ = self._calibration_spectrum(state, geometry)
        avg_db = torch.mean(dft.db20(torch.abs(freq) + 1e-12), dim=1)
        pk_mask = peaks_ops.local_maxima(avg_db) & (avg_db > 0)
        vals = torch.where(pk_mask, avg_db, float("-inf"))
        # lax.top_k breaks ties by the lower index, torch.topk leaves them
        # unordered; ties are -inf entries, which are picked only when fewer
        # than three peaks exist, and then ok is False and the geometry is
        # discarded
        rng_idx = torch.topk(vals, 3).indices

        bf_az0 = torch.abs(beamformed[:, :, 0])  # [range, az]
        # 10*log10 is half of 20*log10, exactly
        az_db = torch.abs(dft.db20(bf_az0[rng_idx] + 1e-12) / 2)  # (3, n_az)
        az_mask = peaks_ops.local_maxima(az_db)
        az_idx = torch.argmax(torch.where(az_mask, az_db, float("-inf")), dim=1)
        ok = (pk_mask.sum() >= 3) & az_mask.any(dim=1).all()
        return CalibrationTargets(rng_idx, az_idx, ok)

    def calibrate_to(self, state: SyntheticArrayState, geometry: torch.Tensor,
                     targets: CalibrationTargets) -> torch.Tensor:
        """The geometry corrected by the phases of the given reflectors (reference :740-816).

        Per target, the unwrapped phase slope of each element after steering
        at it; per element a 3x2 least squares for (dx, dy); their running
        sum is subtracted from the element positions.  ``targets.ok`` is not
        consulted.
        """
        freq, positions = self._calibration_spectrum(state, geometry)
        steering = self._steering_t.reshape(len(self.az_angle_bins_rad),
                                            len(self.el_angle_bins_rad), 3)[targets.az_idx, 0]
        shifted = freq[targets.rng_idx] * steering_phases(steering, positions, self.lambda_m)
        phi = torch.diff(unwrap(torch.angle(shifted), dim=1), dim=1)  # (3, E-1)

        d_j = 2 * np.pi / self.lambda_m * steering[:, 0:2]  # (3, 2)
        # the minimum-norm least-squares solution, as jnp.linalg.lstsq's SVD
        # gives it; torch.linalg.lstsq has only QR on CUDA
        delta_p = torch.linalg.pinv(d_j) @ phi  # (2, E-1)
        corrections = torch.cumsum(delta_p, dim=1)
        new_positions = positions.clone()
        new_positions[0:2, 1:] = positions[0:2, 1:] + (-corrections)
        return new_positions.reshape(3, self.num_frames, -1).permute(1, 0, 2)

    def perform_array_calibration(self, state: SyntheticArrayState, geometry: torch.Tensor,
                                  beamformed: torch.Tensor):
        """Phase self-calibration from targets of opportunity (reference :673-816).

        :meth:`calibration_targets`, then :meth:`calibrate_to` them.  Returns
        ``(corrected_geometry, ok)``; callers keep the original geometry when
        ``ok`` is False (fewer than 3 usable targets).
        """
        targets = self.calibration_targets(state, geometry, beamformed)
        return self.calibrate_to(state, geometry, targets), targets.ok

    # interpolation
    def get_interpolated_response_cart(self, beamformed=None) -> np.ndarray:
        """Bilinear resample of the el=0 slice onto a cartesian grid (host numpy)."""
        if beamformed is None:
            beamformed = self.beamformed_resp
        sl = np.asarray(beamformed)[:, :, 0]
        g = self._interp
        v00 = sl[g["r0"], g["a0"]]
        v01 = sl[g["r0"], g["a0"] + 1]
        v10 = sl[g["r0"] + 1, g["a0"]]
        v11 = sl[g["r0"] + 1, g["a0"] + 1]
        out = (v00 * (1 - g["wr"]) * (1 - g["wa"]) + v01 * (1 - g["wr"]) * g["wa"]
               + v10 * g["wr"] * (1 - g["wa"]) + v11 * g["wr"] * g["wa"])
        out = np.where(g["mask"], out, 0.0)
        self.interpolated_beamformed_resp = out
        return out

    # functional step
    def step(self, state: SyntheticArrayState, adc_cube, current_vel):
        """``(state, frame, vel) -> (state, (response, valid, geometry))``, a pure update."""
        cube = as_complex64(adc_cube, self.device)
        frame = cube[..., self.receiver_idx, :, :][..., :, self._valid_idx_t]
        adc_history = torch.cat([state.adc_history[1:], frame[None]], dim=0)
        vel_history = torch.cat([state.vel_history[1:],
                                 as_float32(current_vel, self.device)[None]], dim=0)
        new_state = SyntheticArrayState(adc_history, vel_history)
        valid = self.update_vel_history(vel_history)
        geometry = self.compute_array_geometry(vel_history)
        resp = self.compute_synthetic_response(new_state, geometry)
        return new_state, (resp, valid, geometry)

    def process(self, adc_cube, current_vel) -> np.ndarray:
        """Reference-compatible API: the response on the host, or an empty array when gated out."""
        self.state, (resp, valid, geometry) = self.step(
            self.state, adc_cube, np.asarray(current_vel, float))
        self.array_geometry = geometry.cpu().numpy()
        self.array_geometry_valid = bool(valid)
        if not self.array_geometry_valid:
            return np.empty(0)

        if self.enable_calibration:
            geom = geometry
            for _ in range(self.num_calibration_iters):
                new_geom, ok = self.perform_array_calibration(self.state, geom, resp)
                if not bool(ok):
                    self.array_geometry_calibrated = geom.cpu().numpy()
                    break
                geom = new_geom
                self.array_geometry_calibrated = geom.cpu().numpy()
                resp = self.compute_synthetic_response(self.state, geom)
        self.beamformed_resp = resp.cpu().numpy()
        self.get_interpolated_response_cart(self.beamformed_resp)
        return self.beamformed_resp

    def reset(self):
        self.state = self.init_state()
        self.array_geometry_valid = False
        super().reset()
