"""Point-cloud generation: detections -> per-detection angles -> cartesian points (JAX: ``processors/point_cloud.py``).

The per-detection angle estimation (antenna snapshots at each detected
(range, vel) cell, zero-padded FFT, argmax; or Capon/MVDR on the detection's
range row) runs over a fixed-capacity padded detection set, so a frame's
raw-cube -> point-cloud pass stays on the device; :meth:`PointCloudGenerator.process`
copies the valid points to the host.

Output is ``(K, 4)`` ``(x, y, z, radial_vel)`` plus a validity mask, in the
FLU frame (x forward, y left, z up).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import beamform as bf, dft
from mmwave_radar_processing_tpu_torch.ops.windows import hanning
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    resolve_device,
)
from mmwave_radar_processing_tpu_torch.processors.detection import (
    Detections,
    get_range_doppler_detector_registry,
)


class PointCloud(NamedTuple):
    """Fixed-capacity padded point cloud."""

    points: torch.Tensor  # (K, 4) float32 (x, y, z, vel)
    valid: torch.Tensor  # (K,) bool
    count: torch.Tensor  # () int32


def aoa_angles(
    rng_dop_raw: torch.Tensor,
    antenna_idxs: torch.Tensor,
    range_idx: torch.Tensor,
    vel_idx: torch.Tensor,
    angle_bins: torch.Tensor,
    *,
    num_angle_bins: int,
    shift: bool,
) -> torch.Tensor:
    """Per-detection angle via zero-padded FFT over an antenna subset.

    Args:
        rng_dop_raw: ``[rx, range, vel]`` complex RD cube (all antennas).
        antenna_idxs: (A,) antenna subset, on the cube's device.
        range_idx / vel_idx: (K,) detection indices (padded entries arbitrary).

    Returns:
        (K,) angles in radians.
    """
    snap = rng_dop_raw[antenna_idxs][:, range_idx, vel_idx].T  # (K, A)
    spec = torch.fft.fft(snap, n=num_angle_bins, dim=1)
    if shift:
        spec = torch.fft.fftshift(spec, dim=1)
    return angle_bins[torch.argmax(torch.abs(spec), dim=1)]


def capon_aoa_angles(
    rng_slow: torch.Tensor,
    antenna_idxs: torch.Tensor,
    range_idx: torch.Tensor,
    angle_bins: torch.Tensor,
    steering: torch.Tensor,
    *,
    loading: float = 1e-2,
) -> torch.Tensor:
    """Per-detection angle via Capon/MVDR on the detection's range row.

    The FFT AoA (:func:`aoa_angles`) uses the single Doppler-cell snapshot,
    so its resolution is the subset's Rayleigh beamwidth.  This estimator
    forms the slow-time covariance of the detection's range row (chirps as
    snapshots) and takes the argmax of the loaded MVDR spectrum: moving
    targets decorrelate across chirps, so two sources inside one beamwidth
    resolve into separate lobes.  The covariances are ``[K, A, A]``, plain
    tensor code on both devices, as in the JAX package.

    Args:
        rng_slow: ``[rx, range, chirp]`` complex range-DFT'd cube (windowed
            range transform only, no Doppler transform).
        antenna_idxs: (A,) antenna subset, on the cube's device.
        range_idx: (K,) detection range rows (padded entries arbitrary).
        steering: complex ``(A, M)`` steering matrix on the angle grid.

    Returns:
        (K,) angles in radians.
    """
    snaps = rng_slow[antenna_idxs][:, range_idx].movedim(0, 1)  # (K, A, C)
    r = bf.spatial_covariance(snaps)  # (K, A, A)
    p = bf.capon_from_covariance(r, steering, loading=loading)  # (K, M)
    return angle_bins[torch.argmax(p, dim=1)]


def spherical_to_cartesian_flu(
    ranges: torch.Tensor, az: torch.Tensor, el: torch.Tensor, vel: torch.Tensor
) -> torch.Tensor:
    """``[..., K]`` spherical detections -> ``[..., K, 4]`` FLU ``(x, y, z, vel)``."""
    x = ranges * torch.cos(el) * torch.cos(az)
    y = ranges * torch.cos(el) * torch.sin(az)
    z = ranges * torch.sin(el)
    return torch.stack([x, y, z, vel], dim=-1)


class PointCloudGenerator(Processor):
    """Raw ADC cube -> (x, y, z, vel) point cloud via a composed RD detector."""

    def __init__(
        self,
        config: RadarConfig,
        az_antenna_idxs: Sequence[int],
        el_antenna_idxs: Sequence[int],
        detector_type: str = "range_doppler_detector_2d",
        detector_params: Optional[Dict] = None,
        shift_az_resp: bool = True,
        shift_el_resp: bool = False,
        num_angle_bins: int = 64,
        aoa_method: str = "fft",
        diagonal_loading: float = 1e-2,
        *,
        device,
        **kwargs,
    ):
        """``aoa_method``: per-detection angle estimator, ``"fft"`` (the
        reference's zero-padded snapshot FFT) or ``"capon"`` (slow-time
        covariance MVDR at the detection's range row; see
        :func:`capon_aoa_angles`)."""
        super().__init__(config)
        if aoa_method not in ("fft", "capon"):
            raise ValueError(f"unknown aoa_method: {aoa_method!r}")
        self.device = resolve_device(device)
        self.aoa_method = aoa_method
        self.diagonal_loading = diagonal_loading
        self.az_antenna_idxs = np.asarray(az_antenna_idxs if az_antenna_idxs is not None else [], int)
        self.el_antenna_idxs = np.asarray(el_antenna_idxs if el_antenna_idxs is not None else [], int)
        self.shift_az_resp = shift_az_resp
        self.shift_el_resp = shift_el_resp
        self.num_angle_bins = num_angle_bins
        self.phase_shifts = grids.phase_shift_bins(num_angle_bins)
        self.angle_bins = grids.angle_bins(num_angle_bins)
        self._angle_bins_t = torch.from_numpy(
            np.asarray(self.angle_bins, np.float32)).to(self.device)
        self._az_idx = torch.as_tensor(self.az_antenna_idxs, device=self.device)
        self._el_idx = torch.as_tensor(self.el_antenna_idxs, device=self.device)

        if aoa_method == "capon":
            ns = self.config.num_adc_samples
            # float32 window, as the JAX processor builds it
            self._rng_dft = dft.to_matrix(dft.dft_factors(
                ns, window=hanning(ns))).to(self.device)
            self._build_steering()

        registry = get_range_doppler_detector_registry()
        if detector_type not in registry:
            raise ValueError(
                f"Unknown detector type: {detector_type}. Available: {list(registry)}"
            )
        self.detector = registry[detector_type](
            self.config, device=self.device, **(detector_params or {}))

    def _build_steering(self) -> None:
        """The Capon steering matrices of both subsets, from ``phase_shifts``."""
        self._az_steering = bf.steering_ula(
            self.phase_shifts, len(self.az_antenna_idxs) or 1).to(self.device)
        self._el_steering = bf.steering_ula(
            self.phase_shifts, len(self.el_antenna_idxs) or 1).to(self.device)

    # ------------------------------------------------------------------ #
    def angles_for_detections(self, rng_dop_raw: torch.Tensor, dets: Detections):
        """(az, el) angles for a padded detection set, by the snapshot FFT."""
        zeros = torch.zeros(dets.range_idx.shape, dtype=torch.float32, device=self.device)
        az = el = zeros
        if self.az_antenna_idxs.size > 0:
            az = aoa_angles(rng_dop_raw, self._az_idx, dets.range_idx, dets.vel_idx,
                            self._angle_bins_t, num_angle_bins=self.num_angle_bins,
                            shift=self.shift_az_resp)
        if self.el_antenna_idxs.size > 0:
            el = aoa_angles(rng_dop_raw, self._el_idx, dets.range_idx, dets.vel_idx,
                            self._angle_bins_t, num_angle_bins=self.num_angle_bins,
                            shift=self.shift_el_resp)
        return az, el

    def _capon_angles_for_detections(self, rng_slow: torch.Tensor, dets: Detections):
        """(az, el) via MVDR on each detection's range row (chirp snapshots)."""
        zeros = torch.zeros(dets.range_idx.shape, dtype=torch.float32, device=self.device)
        az = el = zeros
        if self.az_antenna_idxs.size:
            az = capon_aoa_angles(rng_slow, self._az_idx, dets.range_idx,
                                  self._angle_bins_t, self._az_steering,
                                  loading=self.diagonal_loading)
        if self.el_antenna_idxs.size:
            el = capon_aoa_angles(rng_slow, self._el_idx, dets.range_idx,
                                  self._angle_bins_t, self._el_steering,
                                  loading=self.diagonal_loading)
        return az, el

    def point_cloud(self, adc_cube, **kwargs) -> PointCloud:
        """Cube -> padded point cloud, on the device."""
        cube = as_complex64(adc_cube, self.device)
        raw = self.detector.range_doppler(cube)
        dets = self.detector.detections(cube, rng_dop_raw=raw, **kwargs)
        if self.aoa_method == "capon":
            rng_slow = torch.matmul(self._rng_dft.transpose(0, 1), cube)
            az, el = self._capon_angles_for_detections(rng_slow, dets)
        else:
            az, el = self.angles_for_detections(raw, dets)
        ranges = self.detector._range_bins_t[dets.range_idx]
        vels = self.detector._vel_bins_t[dets.vel_idx]
        pts = spherical_to_cartesian_flu(ranges, az, el, vels)
        pts = torch.where(dets.valid[:, None], pts, 0.0)
        return PointCloud(pts, dets.valid, dets.count)

    def process(self, adc_cube, **kwargs) -> np.ndarray:
        """Reference-compatible API: (N, 4) numpy point cloud."""
        pc = self.point_cloud(adc_cube, **kwargs)
        return pc.points[pc.valid].cpu().numpy()

    def reset(self):
        self.detector.reset()
        super().reset()


_CZT_KEYS = ("czt_band", "czt_awk2", "czt_fwk2", "czt_wk2_m")


def load_detection_constants(processor, jax_side: Dict[str, np.ndarray]) -> None:
    """Place the JAX package's grids and factors in a processor of the detector API.

    ``processor`` is any object of this slice; a ``PointCloudGenerator``
    hands the constants on to its detector and a ground detector to its
    altimeter.  ``jax_side`` holds numpy arrays taken from the JAX objects:

    - ``range_bins_plain``: a ``RangeProcessor``'s grid (``RangeDetector``
      and ``Altimeter`` are such);
    - ``range_bins_eps``, ``vel_bins``: a ``RangeDopplerProcessor``'s grids
      (every range-Doppler detector is such);
    - ``angle_bins``, ``phase_shifts``: a ``PointCloudGenerator``'s grids
      (its Capon steering matrices are rebuilt from the phase shifts);
    - ``czt_band`` (``[m, f1, f2]``) with ``czt_awk2``, ``czt_fwk2`` and
      ``czt_wk2_m``: the static Bluestein factors ``ops/czt.czt_factors``
      returns for that band, for a ``RangeProcessor``.

    Shapes are checked against the processor's own constants; a name that no
    object of the tree takes raises.
    """
    from mmwave_radar_processing_tpu_torch.processors.range_doppler import (
        RangeDopplerProcessor,
    )
    from mmwave_radar_processing_tpu_torch.processors.range_resp import (
        RangeProcessor,
    )

    used = set()

    def grid(obj, attr, key):
        if key not in jax_side:
            return
        value = np.asarray(jax_side[key])
        if value.shape != np.shape(getattr(obj, attr)):
            raise ValueError(f"{key}: shape {value.shape}, the processor's "
                             f"{attr} has {np.shape(getattr(obj, attr))}")
        setattr(obj, attr, value)
        tensor = f"_{attr}_t"
        if hasattr(obj, tensor):
            setattr(obj, tensor, torch.from_numpy(value.astype(np.float32)).to(obj.device))
        used.add(key)

    def visit(obj):
        if isinstance(obj, RangeProcessor):
            grid(obj, "range_bins", "range_bins_plain")
            if any(k in jax_side for k in _CZT_KEYS):
                missing = [k for k in _CZT_KEYS if k not in jax_side]
                if missing:
                    raise ValueError(f"the czt constants come together: missing {missing}")
                m, f1, f2 = (float(v) for v in np.asarray(jax_side["czt_band"]))
                own = obj.static_czt_factors(int(m), f1, f2)
                loaded = []
                for key, mine in zip(_CZT_KEYS[1:], own):
                    value = np.asarray(jax_side[key], np.complex64)
                    if value.shape != tuple(mine.shape):
                        raise ValueError(f"{key}: shape {value.shape}, expected "
                                         f"{tuple(mine.shape)}")
                    loaded.append(torch.from_numpy(value).to(obj.device))
                obj._czt_factors[(int(m), f1, f2)] = tuple(loaded)
                used.update(_CZT_KEYS)
        if isinstance(obj, RangeDopplerProcessor):
            grid(obj, "range_bins", "range_bins_eps")
            grid(obj, "vel_bins", "vel_bins")
            if hasattr(obj, "altimeter"):
                visit(obj.altimeter)
        if isinstance(obj, PointCloudGenerator):
            grid(obj, "angle_bins", "angle_bins")
            grid(obj, "phase_shifts", "phase_shifts")
            if "phase_shifts" in jax_side and obj.aoa_method == "capon":
                obj._build_steering()
            visit(obj.detector)

    visit(processor)
    if set(jax_side) - used:
        raise ValueError(f"constants that no object here takes: "
                         f"{sorted(set(jax_side) - used)}")
