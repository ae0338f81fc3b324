"""Frame-batched payload pipelines behind the viewer (JAX: ``parallel/viewer_pipeline.py``).

The playback controller fans a frame out to fourteen per-frame processors
(``visualization/controller.py``).  These modules compute the same payload
arrays for a whole recording in a few batched calls, so that playback
becomes precompute-then-scrub (``visualization/precompute.py``):

- :func:`build_viewer_payload_pipeline`: per frame the range-Doppler map,
  the range profile, a micro-Doppler column, the Doppler-azimuth and
  range-azimuth maps, the 1D, sequential and 2D CFAR detections and the
  point cloud (the shared angle head, ``point_stages.AngleHead``, on every
  virtual channel), all off one windowed range DFT of every virtual channel;
- :func:`build_ground_detector_stage`: the altitude-gated velocity CFAR of
  the ground detector over maps and an altitude track computed before;
- :func:`build_dbs_viewer_stage`: the plain range-azimuth map, the
  DBS-sharpened map and the speed gate that picks between them.

Per-frame semantics are the registry processors' (same windows, shifts and
bin subsets).  The transforms are complex64 DFT matrices (``ops.dft``); the
ordered-statistic CFARs reach the hand-written kernels on a GPU through
``ops.cfar`` (``os_2d_detect_compact``: the detection kernel; ``os_1d``: the
k-th-smallest kernel); the DBS stage's pick reaches its kernel through
``ops.dft.dbs_pick``.  Precision is full float32 with TF32 off.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import cfar as cfar_ops, dft, masked
from mmwave_radar_processing_tpu_torch.parallel.point_stages import AngleHead, check_planes
from mmwave_radar_processing_tpu_torch.parallel.spectral_pipeline import (
    _build,
    _matrix,
    nearest_doppler_bins,
)
from mmwave_radar_processing_tpu_torch.processors.detection import COS_60, _threshold_1d

#: every output group of the payload pipeline (``rd_map`` and
#: ``range_profile`` are always produced; ``points`` ride with ``det2d``)
GROUPS = frozenset({"md", "da", "ra", "det2d", "detseq", "det1d"})
DEFAULT_INCLUDE = frozenset({"md", "da", "ra", "det2d", "det1d"})


def _int32(*tensors):
    return tuple(t.to(torch.int32) for t in tensors)


class ViewerPayloadPipeline(nn.Module):
    """``(raw_re, raw_im) float32 [B, rx, ns, nc] -> dict`` of payload tensors; see :func:`build_viewer_payload_pipeline`."""

    def __init__(
        self,
        cfg: RadarConfig,
        *,
        rx_idx: int,
        num_angle_bins: int,
        da_rx_antennas: Optional[Sequence[int]],
        valid_angle_range: Sequence[float],
        md_target_ranges: Sequence[float],
        cfar_type: str,
        cfar_params: Optional[dict],
        ra_num_angle_bins: int,
        ra_rx_antennas: Optional[Sequence[int]],
        cfar1d_type: str,
        cfar1d_params: Optional[dict],
        max_dets_1d: int,
        seq_rng_cfar: Optional[tuple],
        seq_vel_cfar: Optional[tuple],
        include: Optional[Sequence[str]],
        az_antenna_idxs: Sequence[int],
        el_antenna_idxs: Sequence[int],
        shift_az_resp: bool,
        shift_el_resp: bool,
        max_dets: int,
    ):
        super().__init__()
        ns, loops = cfg.num_adc_samples, cfg.frame.loops
        self.num_rx, self.cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
        self.frame_shape = (ns, loops * self.cpl)
        n_virtual = cfg.num_virtual_antennas
        self.rx_idx = int(rx_idx)
        self.max_dets, self.max_dets_1d = int(max_dets), int(max_dets_1d)
        self.include = (frozenset(include) if include is not None else DEFAULT_INCLUDE)
        if self.include - GROUPS:
            raise ValueError(f"unknown output groups {sorted(self.include - GROUPS)}, "
                             f"expected a subset of {sorted(GROUPS)}")

        self.register_buffer("chans", torch.arange(n_virtual))
        self.register_buffer("rng", _matrix(ns, window=np.hanning(ns)))
        self.register_buffer("dop", _matrix(loops, window=np.hanning(loops), shift=True))
        # micro-Doppler: unwindowed transforms, rows gated on the eps range grid
        self.register_buffer("rng_plain", _matrix(ns))
        self.register_buffer("dop_plain", _matrix(loops, shift=True))
        rb_eps = grids.range_bins(cfg, variant="eps")
        self.register_buffer("md_mask", torch.from_numpy(
            (rb_eps >= md_target_ranges[0]) & (rb_eps <= md_target_ranges[1])))

        # coarse Doppler-azimuth: zero-padded angle DFT over the selected
        # channels, Hann over them for the standard geometry with virtual
        # antennas; only the valid angle columns are made
        da_rx = (np.arange(n_virtual) if da_rx_antennas is None
                 else np.asarray(da_rx_antennas, int))
        angle_window = (np.hanning(len(da_rx))
                        if (cfg.array_geometry == "standard"
                            and cfg.virtual_antennas_enabled) else None)
        angle_bins = grids.angle_bins(num_angle_bins)
        var = np.asarray(valid_angle_range, float)
        valid_cols = np.flatnonzero((angle_bins >= var[0]) & (angle_bins <= var[1]))
        self.register_buffer("da_rx", torch.from_numpy(da_rx.astype(np.int64)))
        self.register_buffer("da_ang", _matrix(len(da_rx), num_angle_bins, shift=True,
                                               window=angle_window)[:, valid_cols])

        # range-azimuth off chirp 0: the Hann window of the FULL antenna axis,
        # evaluated at each selected channel
        ra_rx = (np.arange(n_virtual) if ra_rx_antennas is None
                 else np.asarray(ra_rx_antennas, int))
        self.register_buffer("ra_rx", torch.from_numpy(ra_rx.astype(np.int64)))
        self.register_buffer("ra_w", torch.from_numpy(
            np.hanning(n_virtual)[ra_rx].astype(np.float32)))
        self.register_buffer("ra_ang", _matrix(len(ra_rx), ra_num_angle_bins, shift=True))

        cfar_params = dict(cfar_params or dict(num_train=(5, 5), num_guard=(3, 2),
                                               pfa=1e-3))
        train, guard = tuple(cfar_params["num_train"]), tuple(cfar_params["num_guard"])
        if cfar_type == "os_cfar_2d":
            rho, alpha = float(cfar_params["rho"]), float(cfar_params["alpha"])

            def detect2d(mag):
                return cfar_ops.os_2d_detect_compact(
                    mag, self.max_dets, num_train=train, num_guard=guard, rho=rho,
                    alpha=alpha)
        elif cfar_type == "ca_cfar_2d":
            pfa = float(cfar_params["pfa"])
            edges = (train[0] + guard[0], train[1] + guard[1])  # +inf thresholds there

            def detect2d(mag):
                thr = cfar_ops.ca_2d(mag, num_train=train, num_guard=guard, pfa=pfa)[0]
                return masked.mask_to_indices_2d(mag > thr, self.max_dets, interior=edges)
        else:
            raise ValueError(f"unknown 2D CFAR kind {cfar_type!r}")
        self._detect2d = detect2d

        self._threshold_1d = _threshold_1d(cfar1d_type, dict(cfar1d_params or dict(
            num_train=5, num_guard=3, rho=0.5, alpha=2)))
        # sequential detector: a range-profile CFAR gates rows, a velocity
        # CFAR runs along every row
        self._seq_rng = _threshold_1d(*(seq_rng_cfar or (
            "os_cfar_1d", dict(num_train=5, num_guard=3, rho=0.6, alpha=2))))
        self._seq_vel = _threshold_1d(*(seq_vel_cfar or (
            "os_cfar_1d", dict(num_train=5, num_guard=2, rho=0.7, alpha=3))))

        # the point cloud's angles index every virtual channel of R
        self.head = AngleHead(cfg, az_pos=az_antenna_idxs, el_pos=el_antenna_idxs,
                              num_angle_bins=num_angle_bins, shift_az_resp=shift_az_resp,
                              shift_el_resp=shift_el_resp)

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor) -> Dict[str, torch.Tensor]:
        check_planes(raw_re, raw_im, frame_shape=self.frame_shape, min_planes=self.num_rx,
                     device=self.rng.device)
        raw = torch.complex(raw_re, raw_im)
        include = self.include
        # the windowed range DFT of every virtual channel, shared by the maps,
        # the profile and the angles
        R = dft.range_dft_channels(raw, self.chans, self.rng, num_rx=self.num_rx,
                                   cfgs_per_loop=self.cpl)  # [B, A, ns, loops]
        D = R @ self.dop
        rd_map = dft.cabs(D[:, self.rx_idx])  # [B, ns, loops]
        range_profile = dft.cabs(R[..., 0]).mean(dim=1)  # [B, ns]
        out = {"rd_map": rd_map, "range_profile": range_profile}

        if "md" in include:
            U = dft.range_dft_channels(raw, (self.rx_idx,), self.rng_plain,
                                       num_rx=self.num_rx, cfgs_per_loop=self.cpl)
            md_mag = dft.cabs(U[:, 0] @ self.dop_plain)
            out["md_col"] = torch.amax(
                torch.where(self.md_mask[:, None], md_mag, float("-inf")), dim=-2)

        if "da" in include:
            spec = torch.movedim(D[:, self.da_rx], 1, -1) @ self.da_ang  # [B, ns, loops, n]
            out["da_map"] = dft.cabs(spec).mean(dim=1)

        if "ra" in include:
            chirp0 = R[:, self.ra_rx, :, 0] * self.ra_w[:, None]  # [B, A, ns]
            out["ra_map"] = dft.cabs(chirp0.transpose(1, 2) @ self.ra_ang)

        if "det1d" in include:
            thr = self._threshold_1d(range_profile)
            idx, valid, _ = masked.mask_to_indices(range_profile > thr, self.max_dets_1d)
            out.update(det1d_idx=idx.to(torch.int32), det1d_valid=valid, det1d_thr=thr)

        if "detseq" in include:
            row_det = range_profile > self._seq_rng(range_profile)
            vel_det = rd_map > self._seq_vel(rd_map)  # every row of every frame at once
            r, v, valid, count = masked.mask_to_indices_2d(
                row_det[..., None] & vel_det, self.max_dets)
            out.update(detseq_r=r.to(torch.int32), detseq_v=v.to(torch.int32),
                       detseq_valid=valid, detseq_count=count)

        if "det2d" in include:
            r_i, v_i, valid, count = self._detect2d(rd_map)
            pts = self.head(R, self.dop, r_i, v_i, valid)
            r_i, v_i = _int32(r_i, v_i)
            out.update(det_r=r_i, det_v=v_i, det_valid=valid, det_count=count,
                       points=pts, pt_valid=valid, pt_count=count)
        return out


class GroundDetectorStage(nn.Module):
    """``(rd_mag [B, ns, nc], altitude [B]) -> (det_r, det_v, det_valid, det_count)``; see :func:`build_ground_detector_stage`."""

    def __init__(self, cfg: RadarConfig, *, vel_cfar_type: str,
                 vel_cfar_params: Optional[dict], max_dets: int):
        super().__init__()
        self._threshold = _threshold_1d(vel_cfar_type, dict(vel_cfar_params or dict(
            num_train=16, num_guard=4, rho=0.5, alpha=12)))
        self.max_dets = int(max_dets)
        bins = grids.range_bins(cfg, variant="eps").astype(np.float32)
        self.register_buffer("bins", torch.from_numpy(bins))
        self.register_buffer("cos60", torch.tensor(COS_60, dtype=torch.float32))

    def range_gate(self, altitude_m: torch.Tensor) -> torch.Tensor:
        """Each frame's row gate ``[altitude bin, bin of min(range max, alt / cos 60)]``, ``bool [B, ns]``.

        All in float32, as the JAX package computes it; ties go to the first
        bin (``torch.argmin``, as ``jnp.argmin``).
        """
        bins, alt = self.bins, altitude_m[:, None]
        min_idx = torch.argmin(torch.abs(bins - alt), dim=1)
        max_rng = torch.minimum(bins.max(), alt / self.cos60)
        max_idx = torch.argmin(torch.abs(bins - max_rng), dim=1)
        rows = torch.arange(bins.shape[0], device=bins.device)
        return (rows >= min_idx[:, None]) & (rows <= max_idx[:, None])

    def forward(self, rd_mag: torch.Tensor, altitude_m: torch.Tensor):
        if rd_mag.dim() != 3 or rd_mag.shape[1] != self.bins.shape[0] \
                or altitude_m.shape != rd_mag.shape[:1]:
            raise ValueError(f"expected maps [B, {self.bins.shape[0]}, nc] and altitudes [B], "
                             f"got {tuple(rd_mag.shape)} and {tuple(altitude_m.shape)}")
        vel_det = rd_mag > self._threshold(rd_mag)  # every row of every frame at once
        gate = self.range_gate(altitude_m.to(torch.float32))
        r, v, valid, count = masked.mask_to_indices_2d(gate[..., None] & vel_det,
                                                       self.max_dets)
        return (*_int32(r, v), valid, count)


class DBSViewerStage(nn.Module):
    """``(raw_re, raw_im, velocity_ned [B, 3]) -> (ra_map, dbs_map, use_dbs)``; see :func:`build_dbs_viewer_stage`."""

    def __init__(self, cfg: RadarConfig, *, num_angle_bins_range_angle_response: int,
                 num_angle_bins_dbs_enhanced_response: int, min_x_y_vel_dbs: float,
                 rx_antennas: Optional[Sequence[int]]):
        super().__init__()
        ns, loops = cfg.num_adc_samples, cfg.frame.loops
        self.num_rx, self.cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
        self.frame_shape = (ns, loops * self.cpl)
        n_virtual = self.cpl * self.num_rx
        a_ra = num_angle_bins_range_angle_response
        a_dbs = num_angle_bins_dbs_enhanced_response
        self.min_x_y_vel_dbs = float(min_x_y_vel_dbs)
        sel = (np.arange(n_virtual) if rx_antennas is None
               else np.asarray(rx_antennas, int))
        self.register_buffer("sel", torch.from_numpy(sel.astype(np.int64)))
        self.register_buffer("rng", _matrix(ns, window=np.hanning(ns)))
        self.register_buffer("dop", _matrix(loops, window=np.hanning(loops), shift=True))
        # plain branch: the full-antenna Hann window, then the subset
        self.register_buffer("ra_w", torch.from_numpy(
            np.hanning(n_virtual)[sel].astype(np.float32)))
        self.register_buffer("ra_ang", _matrix(len(sel), a_ra, shift=True))
        # DBS branch: Hann over the selected antennas; each output angle takes
        # its nearest coarse angle, a fixed choice of the angle DFT's columns
        coarse = grids.angle_bins(a_ra)
        fine = np.linspace(coarse[0], coarse[-1], a_dbs)
        ang_idx = np.argmin(np.abs(coarse[None, :] - fine[:, None]), axis=1)
        self.register_buffer("dbs_ang", _matrix(len(sel), a_ra, shift=True,
                                                window=np.hanning(len(sel)))[:, ang_idx])
        self.register_buffer("vel_bins", torch.from_numpy(
            grids.vel_bins(cfg).astype(np.float32)))
        self.register_buffer("dbs_dirs", torch.from_numpy(
            np.stack([np.cos(fine), np.sin(fine)], axis=1).astype(np.float32)))

    def doppler_bins(self, velocity_ned: torch.Tensor) -> torch.Tensor:
        """Each frame's Doppler bin per DBS angle, ``int64 [B, A_dbs]``: the bin nearest ``-(r_hat . v_xy)``."""
        return nearest_doppler_bins(velocity_ned, self.dbs_dirs, self.vel_bins)

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor,
                velocity_ned: torch.Tensor):
        check_planes(raw_re, raw_im, frame_shape=self.frame_shape, min_planes=self.num_rx,
                     device=self.rng.device)
        b = raw_re.shape[0]
        if velocity_ned.shape != (b, 3) or velocity_ned.dtype != torch.float32 \
                or velocity_ned.device != raw_re.device:
            raise ValueError(f"expected float32 velocities [{b}, 3] on {raw_re.device}, "
                             f"got {velocity_ned.dtype} {tuple(velocity_ned.shape)} "
                             f"on {velocity_ned.device}")
        R = dft.range_dft_channels(torch.complex(raw_re, raw_im), self.sel, self.rng,
                                   num_rx=self.num_rx, cfgs_per_loop=self.cpl)
        chirp0 = R[..., 0] * self.ra_w[:, None]  # [B, A, ns]
        ra_map = dft.cabs(chirp0.transpose(1, 2) @ self.ra_ang)  # [B, ns, A_ra]

        # DBS: Doppler DFT, then per output angle the angle DFT's point at its
        # chosen column and expected Doppler bin, and its magnitude
        dbs_map = dft.dbs_pick(R @ self.dop, self.dbs_ang,
                               self.doppler_bins(velocity_ned))  # [B, ns, A_dbs]
        v = velocity_ned
        use_dbs = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) >= self.min_x_y_vel_dbs
        return ra_map, dbs_map, use_dbs


def build_viewer_payload_pipeline(
    cfg: RadarConfig,
    *,
    rx_idx: int = 0,
    num_angle_bins: int = 64,
    da_rx_antennas: Optional[Sequence[int]] = None,
    valid_angle_range: Sequence[float] = (np.deg2rad(-60), np.deg2rad(60)),
    md_target_ranges: Sequence[float] = (0.0, 1.0),
    cfar_type: str = "ca_cfar_2d",
    cfar_params: Optional[dict] = None,
    ra_num_angle_bins: int = 64,
    ra_rx_antennas: Optional[Sequence[int]] = None,
    cfar1d_type: str = "os_cfar_1d",
    cfar1d_params: Optional[dict] = None,
    max_dets_1d: int = 64,
    seq_rng_cfar: Optional[tuple] = None,
    seq_vel_cfar: Optional[tuple] = None,
    include: Optional[Sequence[str]] = None,
    az_antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    el_antenna_idxs: Sequence[int] = (9, 8, 5, 4),
    shift_az_resp: bool = True,
    shift_el_resp: bool = False,
    max_dets: int = 128,
    device,
) -> ViewerPayloadPipeline:
    """Build the viewer's payload pipeline on ``device`` (``"cpu"`` or ``"cuda[:n]"``).

    The signature mirrors the JAX package's.  The module maps ``(raw_re,
    raw_im) float32 [B, rx, ns, nc]`` to a dict whose leaves all lead with
    ``B``: ``rd_map [ns, loops]``, ``range_profile [ns]``, and by group
    (``include``, a subset of ``{"md", "da", "ra", "det2d", "detseq",
    "det1d"}``; default all but ``detseq``) ``md_col [loops]``, ``da_map
    [loops, n_valid_angles]``, ``ra_map [ns, ra_num_angle_bins]``,
    ``det1d_idx`` / ``det1d_valid [max_dets_1d]`` and ``det1d_thr [ns]``,
    ``detseq_r`` / ``detseq_v`` / ``detseq_valid [max_dets]`` and
    ``detseq_count``, ``det_r`` / ``det_v`` / ``det_valid [max_dets]``,
    ``det_count``, ``points [max_dets, 4]``, ``pt_valid``, ``pt_count``.
    Indices and counts are int32, as in the JAX package.  ``cfar_type`` is
    ``"os_cfar_2d"`` (the counting detection, one kernel launch on a GPU) or
    ``"ca_cfar_2d"``.  Calls :func:`set_full_fp32`.
    """
    return _build(ViewerPayloadPipeline(
        cfg, rx_idx=rx_idx, num_angle_bins=num_angle_bins, da_rx_antennas=da_rx_antennas,
        valid_angle_range=valid_angle_range, md_target_ranges=md_target_ranges,
        cfar_type=cfar_type, cfar_params=cfar_params, ra_num_angle_bins=ra_num_angle_bins,
        ra_rx_antennas=ra_rx_antennas, cfar1d_type=cfar1d_type, cfar1d_params=cfar1d_params,
        max_dets_1d=max_dets_1d, seq_rng_cfar=seq_rng_cfar, seq_vel_cfar=seq_vel_cfar,
        include=include, az_antenna_idxs=az_antenna_idxs, el_antenna_idxs=el_antenna_idxs,
        shift_az_resp=shift_az_resp, shift_el_resp=shift_el_resp, max_dets=max_dets),
        device)


def build_ground_detector_stage(
    cfg: RadarConfig,
    *,
    vel_cfar_type: str = "os_cfar_1d",
    vel_cfar_params: Optional[dict] = None,
    max_dets: int = 128,
    device,
) -> GroundDetectorStage:
    """Build the ground detector's per-frame tail over a recording on ``device``.

    The altitude track comes from the ground scan
    (``build_ground_point_cloud_pipeline(..., stop_after="altitude")``) and
    the maps from the payload pipeline's ``rd_map``.  The module maps
    ``(rd_mag float32 [B, ns, nc], altitude [B])`` to ``(det_r, det_v,
    det_valid, det_count)``: the velocity CFAR along every row, gated to the
    rows from the altitude's bin to the bin of ``min(range max, altitude /
    cos 60 deg)``.
    """
    return _build(GroundDetectorStage(cfg, vel_cfar_type=vel_cfar_type,
                                      vel_cfar_params=vel_cfar_params, max_dets=max_dets),
                  device)


def build_dbs_viewer_stage(
    cfg: RadarConfig,
    *,
    num_angle_bins_range_angle_response: int = 64,
    num_angle_bins_dbs_enhanced_response: int = 64,
    min_x_y_vel_dbs: float = 0.25,
    rx_antennas: Optional[Sequence[int]] = None,
    device,
) -> DBSViewerStage:
    """Build the viewer's DBS stage on ``device``.

    The module maps ``(raw_re, raw_im [B, rx, ns, nc], velocity_ned [B, 3])``
    to ``(ra_map [B, ns, A_ra], dbs_map [B, ns, A_dbs], use_dbs [B])``: both
    branches of ``processors.dbs.RangeAngleProcessorDBSEnhanced`` for every
    frame, and the speed gate ``|v_xy| >= min_x_y_vel_dbs`` that picks one.
    """
    return _build(DBSViewerStage(
        cfg, num_angle_bins_range_angle_response=num_angle_bins_range_angle_response,
        num_angle_bins_dbs_enhanced_response=num_angle_bins_dbs_enhanced_response,
        min_x_y_vel_dbs=min_x_y_vel_dbs, rx_antennas=rx_antennas), device)
