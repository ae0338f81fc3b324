"""Detection pipelines: range detector + the range-Doppler detector family (JAX: ``processors/detection.py``).

Every variant produces a full boolean detection map with tensor code,
converted to fixed-capacity padded ``(range_idx, vel_idx)`` sets at the
boundary:

- ``RangeDopplerDetector2D``: 2D CFAR straight on the RD magnitude map.
- ``RangeDopplerDetectorSequential``: 1D range CFAR gates rows, then a 1D
  velocity CFAR runs on every row (one batched call of the threshold
  function on ``[range, vel]``) and the row gate is ANDed in.
- ``RangeDopplerGroundDetector``: altitude from the (stateful) altimeter sets
  a range gate ``[alt, min(range_max, alt/cos 60 deg)]``; velocity CFAR per
  gated row.

Detections are emitted row-major (range-major), matching ``np.where``.  The
ordered-statistic thresholds run the hand-written CUDA kernels on a GPU
(``ops.cfar``); the object API's ``process`` copies its detections to the
host, ``detections`` keeps them on the device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.ops import cfar as cfar_ops, masked
from mmwave_radar_processing_tpu_torch.processors.altimeter import (
    Altimeter,
    AltimeterState,
)
from mmwave_radar_processing_tpu_torch.processors.base import as_complex64
from mmwave_radar_processing_tpu_torch.processors.range_doppler import (
    RangeDopplerProcessor,
)
from mmwave_radar_processing_tpu_torch.processors.range_resp import (
    RangeProcessor,
    coarse_range_fft,
    hann_window,
)

DEFAULT_MAX_DETS = 256

#: cos(60 deg) in float32, as the JAX package computes it
_COS_60 = float(np.cos(np.deg2rad(np.float32(60.0)), dtype=np.float32))


class Detections(NamedTuple):
    """Fixed-capacity padded detection set over a range-Doppler map."""

    range_idx: torch.Tensor  # (K,) int64
    vel_idx: torch.Tensor  # (K,) int64
    valid: torch.Tensor  # (K,) bool
    count: torch.Tensor  # () int32


def _threshold_1d(kind: str, params: Dict):
    """Bind a 1D CFAR threshold function from registry-style (kind, params)."""
    train, guard = int(params["num_train"]), int(params["num_guard"])
    if kind == "ca_cfar_1d":
        pfa = float(params["pfa"])
        return lambda x: cfar_ops.ca_1d(x, num_train=train, num_guard=guard, pfa=pfa)[0]
    if kind == "os_cfar_1d":
        rho, alpha = float(params["rho"]), float(params["alpha"])
        return lambda x: cfar_ops.os_1d(
            x, num_train=train, num_guard=guard, rho=rho, alpha=alpha)[0]
    if kind in ("go_cfar_1d", "so_cfar_1d"):
        pfa, greatest = float(params["pfa"]), kind == "go_cfar_1d"
        return lambda x: cfar_ops.go_so_1d(
            x, num_train=train, num_guard=guard, pfa=pfa, greatest=greatest)[0]
    raise ValueError(f"unknown 1D CFAR kind {kind!r}")


def _threshold_2d(kind: str, params: Dict):
    train, guard = tuple(params["num_train"]), tuple(params["num_guard"])
    if kind == "ca_cfar_2d":
        pfa = float(params["pfa"])
        return lambda x: cfar_ops.ca_2d(x, num_train=train, num_guard=guard, pfa=pfa)[0]
    if kind == "os_cfar_2d":
        rho, alpha = float(params["rho"]), float(params["alpha"])
        return lambda x: cfar_ops.os_2d(
            x, num_train=train, num_guard=guard, rho=rho, alpha=alpha)[0]
    raise ValueError(f"unknown 2D CFAR kind {kind!r}")


# --------------------------------------------------------------------------- #
# range detector (1D)
# --------------------------------------------------------------------------- #
class RangeDetector(RangeProcessor):
    """Range FFT + 1D CFAR."""

    def __init__(
        self,
        config: RadarConfig,
        cfar_type: str = "os_cfar_1d",
        cfar_params: Optional[Dict] = None,
        max_dets: int = 64,
        *,
        device,
        **kwargs,
    ):
        super().__init__(config, device=device)
        self.cfar_type = cfar_type
        self.cfar_params = cfar_params or dict(num_train=5, num_guard=3, rho=0.5, alpha=2)
        self._threshold = _threshold_1d(cfar_type, self.cfar_params)
        self.max_dets = max_dets
        self.range_resp = None
        self.thresholds = None
        self.dets = None

    def process(self, adc_cube, **kwargs) -> np.ndarray:
        """Detection indices over the coarse range profile, on the host."""
        self.range_resp = self.coarse_fft(adc_cube, chirp_idx=0)
        self.thresholds = self._threshold(self.range_resp)
        det_mask = self.range_resp > self.thresholds
        idx, valid, _ = masked.mask_to_indices(det_mask, self.max_dets)
        self.dets = idx[valid].cpu().numpy()
        return self.dets

    def _map_detections_to_bins(self, dets):
        return np.asarray(self.range_bins)[np.asarray(dets, int)]


# --------------------------------------------------------------------------- #
# range-Doppler detectors
# --------------------------------------------------------------------------- #
class RangeDopplerDetector(RangeDopplerProcessor):
    """Base: computes/caches the full complex RD cube + antenna-0 magnitude."""

    def __init__(self, config: RadarConfig, max_dets: int = DEFAULT_MAX_DETS, *,
                 device, **kwargs):
        super().__init__(config, device=device)
        self.max_dets = max_dets
        self.rng_dop_resp_raw = None
        self.rng_dop_resp = None
        self.dets = None

    # functional core ------------------------------------------------------ #
    def detect_map(self, rd_mag: torch.Tensor, **kw) -> torch.Tensor:
        """Boolean detection map ``[range, vel]``: subclass responsibility."""
        raise NotImplementedError

    def detect_inputs(self, adc_cube: torch.Tensor) -> dict:
        """Extra inputs for :meth:`detect_map` (may advance tracker state)."""
        return {}

    def _compute_range_doppler_response(self, adc_cube):
        self.rng_dop_resp_raw = self.range_doppler(adc_cube)
        self.rng_dop_resp = torch.abs(self.rng_dop_resp_raw[..., 0, :, :])
        return self.rng_dop_resp_raw, self.rng_dop_resp

    def process(self, adc_cube, **kwargs) -> np.ndarray:
        """(N, 2) ``(range_idx, vel_idx)`` detections on the host (reference API)."""
        cube = as_complex64(adc_cube, self.device)
        kwargs = {**self.detect_inputs(cube), **kwargs}
        self._compute_range_doppler_response(cube)
        det_mask = self.detect_map(self.rng_dop_resp, **kwargs)
        r, v, valid, _ = masked.mask_to_indices_2d(det_mask, self.max_dets)
        self.dets = torch.stack([r[valid], v[valid]], dim=1).cpu().numpy()
        return self.dets

    def detections(self, adc_cube, rng_dop_raw: Optional[torch.Tensor] = None,
                   **kwargs) -> Detections:
        """Padded detections that stay on the device.

        ``rng_dop_raw`` may be supplied to reuse an already-computed RD cube.
        """
        cube = as_complex64(adc_cube, self.device)
        kwargs = {**self.detect_inputs(cube), **kwargs}
        raw = rng_dop_raw if rng_dop_raw is not None else self.range_doppler(cube)
        det_mask = self.detect_map(torch.abs(raw[..., 0, :, :]), **kwargs)
        return Detections(*masked.mask_to_indices_2d(det_mask, self.max_dets))

    def _map_detections_to_bins(self, dets: np.ndarray):
        if dets is None or np.size(dets) == 0:
            z = np.array([])
            return z, z, z, z
        r_idx = np.asarray(dets)[:, 0].astype(int)
        v_idx = np.asarray(dets)[:, 1].astype(int)
        return (
            np.asarray(self.range_bins)[r_idx],
            np.asarray(self.vel_bins)[v_idx],
            r_idx,
            v_idx,
        )

    def reset(self):
        super().reset()
        self.rng_dop_resp_raw = None
        self.rng_dop_resp = None
        self.dets = None


class RangeDopplerDetector2D(RangeDopplerDetector):
    """2D CFAR directly on the RD magnitude map."""

    def __init__(
        self,
        config: RadarConfig,
        cfar_type: str = "ca_cfar_2d",
        cfar_params: Optional[Dict] = None,
        **kwargs,
    ):
        super().__init__(config, **kwargs)
        self.cfar_params = cfar_params or dict(num_train=(5, 5), num_guard=(3, 2), pfa=1e-3)
        self._threshold = _threshold_2d(cfar_type, self.cfar_params)

    def detect_map(self, rd_mag: torch.Tensor, **kw) -> torch.Tensor:
        return rd_mag > self._threshold(rd_mag)


class RangeDopplerDetectorSequential(RangeDopplerDetector):
    """1D range CFAR gating rows, then 1D velocity CFAR along each row."""

    def __init__(
        self,
        config: RadarConfig,
        rng_cfar_type: str = "os_cfar_1d",
        rng_cfar_params: Optional[Dict] = None,
        vel_cfar_type: str = "os_cfar_1d",
        vel_cfar_params: Optional[Dict] = None,
        **kwargs,
    ):
        super().__init__(config, **kwargs)
        self._rng_threshold = _threshold_1d(
            rng_cfar_type, rng_cfar_params or dict(num_train=5, num_guard=3, rho=0.6, alpha=2)
        )
        self._vel_threshold = _threshold_1d(
            vel_cfar_type, vel_cfar_params or dict(num_train=5, num_guard=2, rho=0.7, alpha=3)
        )
        self._range_window = hann_window(self.config.num_adc_samples, self.device)

    def detect_map(self, rd_mag: torch.Tensor, range_profile: torch.Tensor = None, **kw):
        row_det = range_profile > self._rng_threshold(range_profile)  # [range]
        vel_det = rd_mag > self._vel_threshold(rd_mag)  # every row at once
        return row_det[..., :, None] & vel_det

    def detect_inputs(self, adc_cube: torch.Tensor) -> dict:
        return {"range_profile": coarse_range_fft(adc_cube[..., :, :, 0],
                                                  self._range_window)}


class RangeDopplerGroundDetector(RangeDopplerDetector):
    """Altitude-gated velocity CFAR for down-facing UAV ground point clouds."""

    def __init__(
        self,
        config: RadarConfig,
        vel_cfar_type: str = "os_cfar_1d",
        vel_cfar_params: Optional[Dict] = None,
        altimeter_params: Optional[Dict] = None,
        **kwargs,
    ):
        super().__init__(config, **kwargs)
        self._vel_threshold = _threshold_1d(
            vel_cfar_type, vel_cfar_params or dict(num_train=16, num_guard=4, rho=0.5, alpha=12)
        )
        altimeter_params = dict(
            altimeter_params
            or dict(
                min_altitude_m=0.25,
                zoom_search_region_m=0.2,
                altitude_search_limit_m=0.4,
                range_bias=0.0,
            )
        )
        self.precise_est_enabled = bool(altimeter_params.pop("precise_est_enabled", True))
        self.altimeter = Altimeter(self.config, device=self.device, **altimeter_params)
        self._rows = torch.arange(len(self.range_bins), device=self.device)

    def range_gate(self, altitude_m: torch.Tensor) -> torch.Tensor:
        """Boolean row gate ``[altitude_bin, min(range_max, alt/cos 60 deg)]``.

        Nearest-bin indices, inclusive; when they coincide the single row
        stays gated.
        """
        bins = self._range_bins_t
        min_idx = torch.argmin(torch.abs(bins - altitude_m))
        max_rng = torch.minimum(bins.max(), altitude_m / _COS_60)
        max_idx = torch.argmin(torch.abs(bins - max_rng))
        return (self._rows >= min_idx) & (self._rows <= max_idx)

    def detect_map(self, rd_mag: torch.Tensor, altitude_m: torch.Tensor = None, **kw):
        vel_det = rd_mag > self._vel_threshold(rd_mag)  # every row at once
        return self.range_gate(altitude_m)[:, None] & vel_det

    def detect_inputs(self, adc_cube: torch.Tensor) -> dict:
        """Runs (and advances) the stateful altimeter tracker."""
        altitude = self.altimeter.process(
            adc_cube, precise_est_enabled=self.precise_est_enabled
        )
        return {"altitude_m": altitude}

    def step(self, alt_state: AltimeterState, adc_cube):
        """Functional variant: ``(alt_state, frame) -> (alt_state, Detections)``."""
        cube = as_complex64(adc_cube, self.device)
        alt_state, altitude = self.altimeter.step(
            alt_state, cube, precise_est_enabled=self.precise_est_enabled
        )
        raw = self.range_doppler(cube)
        det_mask = self.detect_map(torch.abs(raw[..., 0, :, :]), altitude_m=altitude)
        return alt_state, Detections(
            *masked.mask_to_indices_2d(det_mask, self.max_dets))

    def reset(self):
        self.altimeter.reset()
        super().reset()


def get_range_doppler_detector_registry() -> Dict[str, type]:
    """Name -> class map."""
    return {
        "range_doppler_detector_2d": RangeDopplerDetector2D,
        "range_doppler_detector_sequential": RangeDopplerDetectorSequential,
        "range_doppler_ground_detector": RangeDopplerGroundDetector,
    }
