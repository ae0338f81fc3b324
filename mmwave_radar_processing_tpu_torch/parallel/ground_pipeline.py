"""Altimeter-gated ground point clouds over a recording (JAX: ``parallel/ground_pipeline.py``).

The RadVel headline detector: a tracked altitude gates the range-Doppler
rows to ``[altitude, altitude / cos 60deg]`` and a 1D OS-CFAR runs along
each gated Doppler row.  The altitude is the one state carried from frame to
frame; everything else is batched over the recording:

1. ``peak_candidates``: the loop-0 chirp of every virtual channel, its
   Hann-windowed range DFT, the mean magnitude over channels in dB, and its
   three strongest prominent peaks: up to three ground candidates a frame;
2. ``refine_candidates``: for every candidate a zoom DTFT of the chirp over
   ``candidate +- zoom_search_region_m`` and its two strongest peaks.  The
   JAX scan refines only the candidate its recursion picks, inside a
   ``lax.cond``; the refinement depends on the altitude only through that
   pick, so refining all three and picking afterwards gives the same values;
3. the recursion (:func:`..ops.altitude.altitude_track`): one hand-written
   CUDA kernel on a GPU, the plain loop on the CPU;
4. ``detect_frames``: the point-cloud pipeline's front on the antenna
   union (``point_stages.antenna_union``, ``ops.dft.range_dft_input``), the
   Doppler DFT of channel 0 and its magnitude, the altitude row gate, the 1D
   OS-CFAR by counting, compaction of the first ``max_dets`` detections, and
   the shared angle head (``point_stages.AngleHead``) for the FLU points.

A call is the span ``mmw.gnd`` (``utils/profiling.annotate``) around its
stages: ``mmw.gnd.range`` (the planes check, the loop-0 chirps, the coarse
range DFT and the candidates' peaks), ``mmw.gnd.zoom`` (the factor build,
the zoom DTFT and its peaks; precise only), ``mmw.gnd.track`` (the
recursion), ``mmw.gnd.detect`` (the range-Doppler front, the row gate, the
1D OS-CFAR and the compaction) and ``mmw.gnd.aoa`` (the angle head).  A
call reads nothing back to the host.

Precision is full float32 with TF32 off; the pipeline has no weights and uses
no randomness.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import dft
from mmwave_radar_processing_tpu_torch.ops import peaks as peaks_ops
from mmwave_radar_processing_tpu_torch.ops.altitude import altitude_track
from mmwave_radar_processing_tpu_torch.ops.cfar import os_1d_detect
from mmwave_radar_processing_tpu_torch.ops.masked import mask_to_indices_2d
from mmwave_radar_processing_tpu_torch.parallel.pipeline import set_full_fp32
from mmwave_radar_processing_tpu_torch.parallel.point_stages import (
    AngleHead,
    antenna_union,
    check_planes,
)
from mmwave_radar_processing_tpu_torch.processors.base import resolve_device
from mmwave_radar_processing_tpu_torch.processors.detection import COS_60
from mmwave_radar_processing_tpu_torch.utils.profiling import annotate, timed_builder

DEFAULT_VEL_CFAR_PARAMS = dict(num_train=12, num_guard=4, rho=0.5, alpha=15.0)
STOP_AFTER = (None, "altitude")


class GroundPipelineOut(NamedTuple):
    points: torch.Tensor  # float32 [T, K, 4]
    valid: torch.Tensor  # bool [T, K]
    count: torch.Tensor  # int32 [T]
    altitude: torch.Tensor  # float32 [T]: tracked altitude + range_bias
    final_altitude: torch.Tensor  # float32 []: the carry of a chunked recording


class GroundPipeline(nn.Module):
    """``(raw_re, raw_im) float32 [T, rx, ns, nc] -> GroundPipelineOut`` over one recording.

    The frames are in time order.  ``forward(..., init_altitude=)`` starts
    the tracker at a given altitude (a float or a scalar tensor), such as the
    ``final_altitude`` of the previous chunk.  With ``reformat_input=False``
    the planes are virtual cubes ``[T, virtual channels, ns, loops]``.  Build
    it with :func:`build_ground_point_cloud_pipeline`.
    """

    def __init__(
        self,
        cfg: RadarConfig,
        *,
        az_antenna_idxs: Sequence[int],
        el_antenna_idxs: Sequence[int],
        vel_cfar_params: dict,
        min_altitude_m: float,
        zoom_search_region_m: float,
        altitude_search_limit_m: float,
        range_bias: float,
        precise_est_enabled: bool,
        max_dets: int,
        num_angle_bins: int,
        shift_az_resp: bool,
        shift_el_resp: bool,
        reformat_input: bool,
        stop_after: Optional[str],
    ):
        super().__init__()
        ns, loops = cfg.num_adc_samples, cfg.frame.loops
        self.ns = ns
        self.num_rx, self.cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
        self.reformat_input, self.stop_after = reformat_input, stop_after
        self.frame_shape = (ns, loops * self.cpl) if reformat_input else (ns, loops)
        self.max_dets = max_dets
        self.min_altitude_m = float(min_altitude_m)
        self.zoom_search_region_m = float(zoom_search_region_m)
        self.altitude_search_limit_m = float(altitude_search_limit_m)
        self.range_bias = float(range_bias)
        self.precise = bool(precise_est_enabled)
        self.cfar = dict(num_train=int(vel_cfar_params["num_train"]),
                         num_guard=int(vel_cfar_params["num_guard"]),
                         rho=float(vel_cfar_params["rho"]),
                         alpha=float(vel_cfar_params["alpha"]))
        # the 1D CFAR leaves the first and last edge_d Doppler columns False:
        # only the interior columns are compacted
        edge_d = self.cfar["num_train"] + self.cfar["num_guard"]
        self.interior = (0, edge_d) if loops - 2 * edge_d > 0 else None

        layout = antenna_union(az_antenna_idxs, el_antenna_idxs,
                               reformat_input=reformat_input, num_rx=self.num_rx)
        self.min_planes = layout.min_planes
        self.ch0_pos, self.aoa_start = layout.ch0_pos, layout.aoa_start

        plain = grids.range_bins(cfg, variant="plain")
        self.max_plain = float(np.max(plain))
        # altimeter zoom frequency mapping (reference range_resp.py:84-89)
        self.zoom_fs = 1.0 / cfg.range_res_m
        self.zoom_scale = self.zoom_fs / cfg.range_max_m

        rng_factors, dop_factors = dft.range_doppler_factors(ns, loops)
        # the altimeter's range DFT is the same Hann-windowed matrix
        self.register_buffer("rng_dft", dft.to_matrix(rng_factors))
        self.register_buffer("dop_dft", dft.to_matrix(dop_factors))
        self.register_buffer("plain_bins", torch.from_numpy(plain.astype(np.float32)))
        self.register_buffer("eps_bins", torch.from_numpy(
            grids.range_bins(cfg, variant="eps").astype(np.float32)))
        self.register_buffer("chans", torch.from_numpy(layout.chans.astype(np.int64)))
        self.register_buffer("zoom_window", torch.from_numpy(np.hanning(ns).astype(np.float32)))
        self.head = AngleHead(cfg, az_pos=layout.az_pos, el_pos=layout.el_pos,
                              num_angle_bins=num_angle_bins, shift_az_resp=shift_az_resp,
                              shift_el_resp=shift_el_resp)

    # ------------------------------------------------------------------ #
    def loop0_chirps(self, raw: torch.Tensor) -> torch.Tensor:
        """``complex64 [T, V, ns]``: the loop-0 chirp of every virtual channel.

        For a raw cube, chirp ``cfg`` of receiver ``r`` is virtual channel
        ``v = cfg*num_rx + r`` (TDM order, ``processors/virtual_array``).
        """
        if not self.reformat_input:
            return raw[..., 0]
        c0 = torch.movedim(raw[:, :self.num_rx, :, :self.cpl], -1, -3)
        return c0.reshape(raw.shape[0], self.cpl * self.num_rx, self.ns)

    def _top_peak_ranges(self, spec: torch.Tensor, max_peaks: int):
        """Mean magnitude over channels (axis -2) in dB, and its top prominent peaks."""
        db = dft.db20(dft.cabs(spec).mean(dim=-2) + 1e-12)
        return peaks_ops.top_peaks_within_threshold(
            db, max_peaks=max_peaks, min_prominence=6.0, threshold_db=20.0)

    def peak_candidates(self, chirp0: torch.Tensor):
        """``[T, V, ns] -> (cand float32 [T, 3], valid bool [T, 3])``: coarse ground candidates (m)."""
        idx, _, valid = self._top_peak_ranges(torch.matmul(chirp0, self.rng_dft), 3)
        return torch.where(valid, self.plain_bins[idx], 0.0), valid

    def refine_candidates(self, chirp0: torch.Tensor, cand: torch.Tensor):
        """Zoom refinements of every candidate: ``[..., V, ns], [..., K] -> ([..., K, 2], [..., K, 2])``.

        The band of a candidate ``c`` is ``[max(1e-6, c - r), min(max_range -
        1e-6, c + r)]``; its ``ns`` zoom bins are ``lo + i*(hi - lo)/(ns - 1)``.
        Returns the two strongest peaks' ranges (0 where there is none) and
        their validity.
        """
        lo = torch.clamp_min(cand - self.zoom_search_region_m, 1e-6)
        hi = torch.clamp_max(cand + self.zoom_search_region_m, self.max_plain - 1e-6)
        factors = dft.zoom_dft_factors(lo * self.zoom_scale, hi * self.zoom_scale,
                                       n=self.ns, m=self.ns, fs=self.zoom_fs,
                                       window=self.zoom_window)
        zspec = torch.matmul(chirp0[..., None, :, :], dft.to_matrix(factors))
        zidx, _, zvalid = self._top_peak_ranges(zspec, 2)
        zbins = lo[..., None] + zidx.to(torch.float32) * (hi - lo)[..., None] / (self.ns - 1)
        return torch.where(zvalid, zbins, 0.0), zvalid

    def altitude_inputs(self, raw_re: torch.Tensor, raw_im: torch.Tensor):
        """The recursion's inputs ``(cand, valid, zbins, zvalid)`` of a recording (refinements None unless precise)."""
        return self._altitude_inputs(raw_re, raw_im)[1:]

    def _altitude_inputs(self, raw_re: torch.Tensor, raw_im: torch.Tensor):
        """``(raw, cand, valid, zbins, zvalid)``: the complex planes and the recursion's inputs, in their spans."""
        with annotate("mmw.gnd.range"):
            check_planes(raw_re, raw_im, frame_shape=self.frame_shape,
                         min_planes=self.min_planes, device=self.rng_dft.device)
            raw = torch.complex(raw_re, raw_im)
            chirp0 = self.loop0_chirps(raw)
            cand, valid = self.peak_candidates(chirp0)
        zbins = zvalid = None
        if self.precise:
            with annotate("mmw.gnd.zoom"):
                zbins, zvalid = self.refine_candidates(chirp0, cand)
        return raw, cand, valid, zbins, zvalid

    def track(self, cand, valid, zbins, zvalid, init: torch.Tensor):
        """The recursion: ``(alts [T], final [])`` (the kernel on a GPU)."""
        return altitude_track(
            cand, valid, zbins, zvalid, init, min_altitude_m=self.min_altitude_m,
            altitude_search_limit_m=self.altitude_search_limit_m,
            range_bias=self.range_bias, precise=self.precise)

    def start(self, init_altitude=None) -> torch.Tensor:
        """The tracker's start as a float32 scalar on the device: ``min_altitude_m``, a float or a scalar tensor.

        A float is filled in on the device and a tensor converted there, so
        neither copies from the host's memory.
        """
        device = self.rng_dft.device
        if init_altitude is None or not isinstance(init_altitude, torch.Tensor):
            start = self.min_altitude_m if init_altitude is None else float(init_altitude)
            return torch.full((), start, dtype=torch.float32, device=device)
        return init_altitude.to(device=device, dtype=torch.float32).reshape(())

    def detect_frames(self, raw: torch.Tensor, corrected: torch.Tensor):
        """Stateless detection of every frame at its altitude: ``(points, valid, count)``."""
        with annotate("mmw.gnd.detect"):
            R = dft.range_dft_input(raw, self.chans, self.rng_dft,
                                    reformat_input=self.reformat_input, num_rx=self.num_rx,
                                    cfgs_per_loop=self.cpl)
            mag = dft.cabs(torch.matmul(R[:, self.ch0_pos], self.dop_dft))  # [T, W, V]

            # altitude row gate: nearest bins, inclusive (reference :89-103)
            bins = self.eps_bins
            min_idx = torch.argmin(torch.abs(bins - corrected[:, None]), dim=-1)
            max_rng = torch.minimum(bins.max(), corrected / COS_60)
            max_idx = torch.argmin(torch.abs(bins - max_rng[:, None]), dim=-1)
            rows = torch.arange(bins.shape[0], device=bins.device)
            row_gate = (rows >= min_idx[:, None]) & (rows <= max_idx[:, None])

            det_mask = row_gate[:, :, None] & os_1d_detect(mag, **self.cfar)
            r_i, v_i, valid, count = mask_to_indices_2d(det_mask, self.max_dets,
                                                        interior=self.interior)
        with annotate("mmw.gnd.aoa"):
            pts = self.head(R[:, self.aoa_start:], self.dop_dft, r_i, v_i, valid)
        return pts, valid, count

    def scan(self, raw_re: torch.Tensor, raw_im: torch.Tensor, init_altitude=None):
        """The stages of a call, each in its span, inside a ``mmw.gnd`` span the caller opens."""
        raw, *inputs = self._altitude_inputs(raw_re, raw_im)
        with annotate("mmw.gnd.track"):
            alts, final = self.track(*inputs, self.start(init_altitude))
        if self.stop_after == "altitude":
            return alts, final
        pts, valid, count = self.detect_frames(raw, alts)
        return GroundPipelineOut(pts, valid, count, alts, final)

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor, init_altitude=None):
        with annotate("mmw.gnd"):
            return self.scan(raw_re, raw_im, init_altitude)


@timed_builder("ground")
def build_ground_point_cloud_pipeline(
    cfg: RadarConfig,
    *,
    az_antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    el_antenna_idxs: Sequence[int] = (9, 8, 5, 4),
    vel_cfar_params: Optional[dict] = None,
    min_altitude_m: float = 0.25,
    zoom_search_region_m: float = 0.2,
    altitude_search_limit_m: float = 0.4,
    range_bias: float = 0.0,
    precise_est_enabled: bool = True,
    max_dets: int = 128,
    num_angle_bins: int = 64,
    aoa_precision: str = "f32",
    shift_az_resp: bool = True,
    shift_el_resp: bool = False,
    reformat_input: bool = True,
    stop_after: Optional[str] = None,
    device,
) -> GroundPipeline:
    """Build the ground scan on ``device`` (``"cpu"`` or ``"cuda[:n]"``).

    The signature mirrors the JAX package's.  ``aoa_precision`` is ``"f32"``
    only (the port has no reduced-precision mode; the JAX ``"fast"`` default
    is float32 on a CPU as well).  ``stop_after="altitude"`` returns just
    ``(altitude [T], final_altitude [])``.  Calls :func:`set_full_fp32`.
    """
    if aoa_precision != "f32":
        raise ValueError(f"aoa_precision={aoa_precision!r} is not ported: the "
                         "port runs full float32 only ('f32')")
    if stop_after not in STOP_AFTER:
        raise ValueError(f"stop_after={stop_after!r}: expected one of {STOP_AFTER}")
    if not isinstance(reformat_input, bool):
        raise ValueError(f"reformat_input={reformat_input!r}: expected a bool")
    device = resolve_device(device)
    set_full_fp32()
    pipeline = GroundPipeline(
        cfg,
        az_antenna_idxs=az_antenna_idxs,
        el_antenna_idxs=el_antenna_idxs,
        vel_cfar_params=vel_cfar_params or DEFAULT_VEL_CFAR_PARAMS,
        min_altitude_m=min_altitude_m,
        zoom_search_region_m=zoom_search_region_m,
        altitude_search_limit_m=altitude_search_limit_m,
        range_bias=range_bias,
        precise_est_enabled=precise_est_enabled,
        max_dets=max_dets,
        num_angle_bins=num_angle_bins,
        shift_az_resp=shift_az_resp,
        shift_el_resp=shift_el_resp,
        reformat_input=reformat_input,
        stop_after=stop_after,
    )
    return pipeline.to(device)
