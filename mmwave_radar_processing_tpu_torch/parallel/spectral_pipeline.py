"""Frame-batched pipelines of the spectral-map family (JAX: ``parallel/spectral_pipeline.py``).

Raw ADC planes in, the maps that the viewer and the plotting stack consume
out, at batch throughput:

- :func:`build_spectral_maps_pipeline`: per frame the range-Doppler
  magnitude of one RX, the range-azimuth map and the coarse Doppler-azimuth
  map (:class:`SpectralMaps`);
- :func:`build_micro_doppler_pipeline`: the spectrogram after every frame of
  a recording.  Each column depends only on its own frame, so all columns
  are computed at once and the shift-register history becomes one gather
  (``processors.micro_doppler.spectrogram_stack``), equal to the scan;
- :func:`build_strip_map_pipeline`: the full strip-map SAR magnitude;
- :func:`build_dbs_pipeline`: DBS-sharpened range-angle maps for per-frame
  platform velocities, blended per frame with the plain range-angle map on
  the speed gate (both are computed, as in the JAX package).  Its stages
  are spans inside ``mmw.dbs`` (``utils/profiling.annotate``):
  ``mmw.dbs.front`` (the planes check, the channels, the range and Doppler
  DFTs), ``mmw.dbs.pick`` (the Doppler bins, then the angle DFT's point at
  each kept (Doppler bin, angle) and its magnitude, ``ops.dft.dbs_pick``:
  the hand-written CUDA kernel on the card; the angle cube is never formed)
  and ``mmw.dbs.plain`` (the fallback map); the gate's select lies in
  ``mmw.dbs`` itself.

The transforms are DFT matrices built as the JAX package builds its factors
(``ops.dft``), applied as complex matmuls; the virtual-array reformat is
folded into the channel selection (``reformat_channels``) unless
``reformat_input=False``, which takes virtual cubes ``[B, n_virtual, ns,
loops]``.  No step of these paths has a TPU kernel: the JAX package computes
them in plain XLA.  One has a hand-written CUDA kernel, DBS's pick.
Precision is full float32 with TF32 off.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import dft
from mmwave_radar_processing_tpu_torch.parallel.pipeline import set_full_fp32
from mmwave_radar_processing_tpu_torch.parallel.point_stages import check_planes
from mmwave_radar_processing_tpu_torch.processors.base import resolve_device
from mmwave_radar_processing_tpu_torch.processors.micro_doppler import spectrogram_stack
from mmwave_radar_processing_tpu_torch.processors.virtual_array import reformat_channels
from mmwave_radar_processing_tpu_torch.utils.profiling import annotate, timed_builder


class SpectralMaps(NamedTuple):
    range_doppler: torch.Tensor  # float32 [B, ns, loops]
    range_angle: torch.Tensor  # float32 [B, ns, num_angle_bins]
    doppler_azimuth: torch.Tensor  # float32 [B, loops, n_valid_angles]


def _matrix(*args, **kwargs) -> torch.Tensor:
    return dft.to_matrix(dft.dft_factors(*args, **kwargs))


class _SpectralPipeline(nn.Module):
    """The shared front end: input checks and the virtual channels a map needs."""

    def __init__(self, cfg: RadarConfig, *, reformat_input: bool, channels: Sequence[int]):
        super().__init__()
        self.ns, self.loops = cfg.num_adc_samples, cfg.frame.loops
        self.num_rx, self.cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
        self.reformat_input = reformat_input
        self.frame_shape = (self.ns, self.loops * (self.cpl if reformat_input else 1))
        self.min_planes = self.num_rx if reformat_input else max(channels) + 1

    def _channels(self, raw_re: torch.Tensor, raw_im: torch.Tensor,
                  *channel_sets: Sequence[int]):
        """Each channel set of the checked planes: complex64 ``[B, len(set), ns, loops]``."""
        check_planes(raw_re, raw_im, frame_shape=self.frame_shape,
                     min_planes=self.min_planes, device=next(self.buffers()).device)
        raw = torch.complex(raw_re, raw_im)
        if self.reformat_input:
            return [reformat_channels(raw, channels=tuple(int(v) for v in chans),
                                      num_rx=self.num_rx, cfgs_per_loop=self.cpl)
                    for chans in channel_sets]
        return [raw[:, list(chans)] for chans in channel_sets]


class SpectralMapsPipeline(_SpectralPipeline):
    """``(raw_re, raw_im) float32 [B, rx, ns, nc] -> SpectralMaps``; build it with :func:`build_spectral_maps_pipeline`."""

    def __init__(self, cfg: RadarConfig, *, rx_idx: int, ra_rx_antennas: Sequence[int],
                 da_rx_antennas: Sequence[int], num_angle_bins: int,
                 valid_angle_range: Sequence[float], chirp_idx: int,
                 da_shift_angle: bool, reformat_input: bool):
        ra_idx = tuple(int(v) for v in ra_rx_antennas)
        da_idx = tuple(int(v) for v in da_rx_antennas)
        super().__init__(cfg, reformat_input=reformat_input,
                         channels=(int(rx_idx),) + ra_idx + da_idx)
        self.rx_idx, self.chirp_idx = int(rx_idx), int(chirp_idx)
        self.ra_idx, self.da_idx = ra_idx, da_idx
        ns, loops = self.ns, self.loops
        angle_bins = grids.angle_bins(num_angle_bins)
        var = np.asarray(valid_angle_range, float)
        valid_cols = np.flatnonzero((angle_bins >= var[0]) & (angle_bins <= var[1]))

        rd_rng, rd_dop = dft.range_doppler_factors(ns, loops)
        self.register_buffer("rd_rng", dft.to_matrix(rd_rng))
        self.register_buffer("rd_dop", dft.to_matrix(rd_dop))
        # range-angle: the Hann window over the *full* antenna axis, taken
        # before the selection (reference range_angle_resp.py:95-101)
        n_virtual = self.num_rx * self.cpl
        self.register_buffer("ra_window", torch.from_numpy(
            np.hanning(n_virtual).astype(np.float32)[list(self.ra_idx)]))
        self.register_buffer("ra_rng", _matrix(ns, window=np.hanning(ns)))
        self.register_buffer("ra_ant", _matrix(len(self.ra_idx), num_angle_bins,
                                               shift=True))
        # coarse Doppler-azimuth over the selected sub-array: only the valid
        # angle columns of its angle DFT are made
        self.register_buffer("da_rng", _matrix(ns, window=np.hanning(ns)))
        self.register_buffer("da_chirp", _matrix(loops, window=np.hanning(loops),
                                                 shift=True))
        self.register_buffer("da_ant", _matrix(len(self.da_idx), num_angle_bins,
                                               shift=da_shift_angle)[:, valid_cols])
        self.angle_window_da = (cfg.array_geometry == "standard"
                                and cfg.virtual_antennas_enabled)
        self.register_buffer("da_window", torch.from_numpy(
            np.hanning(len(self.da_idx)).astype(np.float32)))

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor) -> SpectralMaps:
        rd_in, ra_in, da_in = self._channels(raw_re, raw_im, (self.rx_idx,), self.ra_idx,
                                             self.da_idx)
        rd = self.rd_rng.transpose(0, 1) @ rd_in[:, 0] @ self.rd_dop  # [B, ns, loops]

        chirp = ra_in[..., self.chirp_idx] * self.ra_window[:, None]  # [B, A, ns]
        ra = (chirp @ self.ra_rng).transpose(1, 2) @ self.ra_ant  # [B, ns, M]

        if self.angle_window_da:
            da_in = da_in * self.da_window[:, None, None]
        rng = self.da_rng.transpose(0, 1) @ da_in  # [B, A, ns, loops]
        spec = self.da_chirp.transpose(0, 1) @ torch.movedim(rng, 1, -1)  # [B, ns, loops, A]
        da = dft.cabs(spec @ self.da_ant).mean(dim=1)  # [B, loops, n_valid]
        return SpectralMaps(dft.cabs(rd), dft.cabs(ra), da)


class MicroDopplerPipeline(_SpectralPipeline):
    """``(raw_re, raw_im) float32 [T, rx, ns, nc] -> float32 [T, loops, history]``; see :func:`build_micro_doppler_pipeline`."""

    def __init__(self, cfg: RadarConfig, *, rx_idx: int, target_ranges: Sequence[float],
                 num_frames_history: int, reformat_input: bool):
        super().__init__(cfg, reformat_input=reformat_input, channels=(int(rx_idx),))
        self.rx_idx, self.num_frames_history = int(rx_idx), int(num_frames_history)
        range_bins = grids.range_bins(cfg, variant="eps")
        tr = np.asarray(target_ranges, float)
        self.register_buffer("range_mask", torch.from_numpy(
            (range_bins >= tr[0]) & (range_bins <= tr[1])))
        # no windows in the reference's micro-Doppler transform
        self.register_buffer("rng", _matrix(self.ns))
        self.register_buffer("dop", _matrix(self.loops, shift=True))

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor) -> torch.Tensor:
        (sl,) = self._channels(raw_re, raw_im, (self.rx_idx,))
        mag = dft.cabs(self.rng.transpose(0, 1) @ sl[:, 0] @ self.dop)  # [T, ns, loops]
        cols = torch.amax(torch.where(self.range_mask[:, None], mag, float("-inf")),
                          dim=-2)
        return spectrogram_stack(cols, self.num_frames_history)


class StripMapPipeline(_SpectralPipeline):
    """``(raw_re, raw_im) float32 [B, rx, ns, nc] -> float32 [B, ns, loops]``; see :func:`build_strip_map_pipeline`."""

    def __init__(self, cfg: RadarConfig, *, rx_index: int, reformat_input: bool):
        super().__init__(cfg, reformat_input=reformat_input, channels=(int(rx_index),))
        self.rx_index = int(rx_index)
        self.register_buffer("rng", _matrix(self.ns))
        self.register_buffer("dop", _matrix(self.loops, shift=True))

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor) -> torch.Tensor:
        (sl,) = self._channels(raw_re, raw_im, (self.rx_index,))
        return dft.cabs(self.rng.transpose(0, 1) @ sl[:, 0] @ self.dop)


def nearest_doppler_bins(velocity_ned: torch.Tensor, dirs: torch.Tensor,
                         vel_bins: torch.Tensor) -> torch.Tensor:
    """``int64 [B, n]``: for each frame and look direction ``dirs [n, 2]`` (unit ``(cos, sin)``), the bin of ``vel_bins`` nearest the ground's Doppler ``-(r_hat @ v[:2])``; ties go to the first bin."""
    dop_vel = -(velocity_ned[:, :2] @ dirs.transpose(0, 1))
    return torch.argmin(torch.abs(vel_bins - dop_vel[..., None]), dim=-1)


class DBSPipeline(_SpectralPipeline):
    """``(raw_re, raw_im, velocity_ned [B, 3]) -> float32 [B, ns, n_dbs]``; see :func:`build_dbs_pipeline`."""

    def __init__(self, cfg: RadarConfig, *, rx_antennas: Sequence[int], num_angle_bins: int,
                 num_dbs_angle_bins: int, min_x_y_vel_dbs: float, chirp_idx: int,
                 reformat_input: bool):
        rx_idx = tuple(int(v) for v in rx_antennas)
        super().__init__(cfg, reformat_input=reformat_input, channels=rx_idx)
        self.rx_idx = rx_idx
        self.chirp_idx, self.min_x_y_vel_dbs = int(chirp_idx), float(min_x_y_vel_dbs)
        ns, loops, a = self.ns, self.loops, len(self.rx_idx)
        angle_bins = grids.angle_bins(num_angle_bins)
        dbs_bins = np.linspace(angle_bins[0], angle_bins[-1], num_dbs_angle_bins)
        # the nearest coarse angle of each DBS angle (fixed)
        ang_near = np.argmin(np.abs(angle_bins[None, :] - dbs_bins[:, None]), axis=1)
        self.register_buffer("ang_near", torch.from_numpy(ang_near))
        self.register_buffer("vel_bins", torch.from_numpy(
            grids.vel_bins(cfg).astype(np.float32)))
        self.register_buffer("dbs_dirs", torch.from_numpy(np.stack(
            [np.cos(dbs_bins), np.sin(dbs_bins)], axis=1).astype(np.float32)))

        self.register_buffer("rng", _matrix(ns, window=np.hanning(ns)))
        self.register_buffer("dop", _matrix(loops, window=np.hanning(loops), shift=True))
        # the windowed angle DFT's column of each DBS angle's coarse angle
        self.register_buffer("pick_weights", _matrix(
            a, num_angle_bins, shift=True, window=np.hanning(a))[:, ang_near].contiguous())
        # the plain range-angle path windows the FULL antenna axis before
        # the selection
        n_virtual = self.num_rx * self.cpl
        self.register_buffer("ra_window", torch.from_numpy(
            np.hanning(n_virtual).astype(np.float32)[list(self.rx_idx)]))
        self.register_buffer("ra_rng", _matrix(ns, window=np.hanning(ns)))
        self.register_buffer("ra_ant", _matrix(a, num_angle_bins, shift=True))

    def doppler_bins(self, velocity_ned: torch.Tensor) -> torch.Tensor:
        """Each frame's Doppler bin per DBS angle, ``[B, n_dbs]``: the bin nearest ``-(r_hat @ v[:2])``."""
        return nearest_doppler_bins(velocity_ned, self.dbs_dirs, self.vel_bins)

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor,
                velocity_ned: torch.Tensor) -> torch.Tensor:
        with annotate("mmw.dbs"):
            with annotate("mmw.dbs.front"):
                (sub,) = self._channels(raw_re, raw_im, self.rx_idx)
                b = sub.shape[0]
                if velocity_ned.shape != (b, 3) or velocity_ned.dtype != torch.float32 \
                        or velocity_ned.device != sub.device:
                    raise ValueError(f"expected float32 velocities [{b}, 3] on {sub.device}, "
                                     f"got {velocity_ned.dtype} {tuple(velocity_ned.shape)} "
                                     f"on {velocity_ned.device}")
                # DBS: the windowed range and Doppler DFTs, then per DBS angle the
                # angle DFT's point at its nearest coarse angle and expected Doppler bin
                spec = self.rng.transpose(0, 1) @ sub @ self.dop  # [B, A, ns, loops]
            with annotate("mmw.dbs.pick"):
                sharpened = dft.dbs_pick(spec, self.pick_weights,
                                         self.doppler_bins(velocity_ned))  # [B, ns, n_dbs]

            with annotate("mmw.dbs.plain"):
                # the plain range-angle map, resampled to the nearest angle
                chirp = sub[..., self.chirp_idx] * self.ra_window[:, None]  # [B, A, ns]
                ra = (chirp @ self.ra_rng).transpose(1, 2) @ self.ra_ant  # [B, ns, M]
                plain = dft.cabs(ra)[:, :, self.ang_near]

            v = velocity_ned
            fast = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) >= self.min_x_y_vel_dbs
            return torch.where(fast[:, None, None], sharpened, plain)


def _build(module: nn.Module, device) -> nn.Module:
    device = resolve_device(device)
    set_full_fp32()
    return module.to(device)


def build_spectral_maps_pipeline(
    cfg: RadarConfig,
    *,
    rx_idx: int = 0,
    ra_rx_antennas: Sequence[int] = (0, 3, 4, 7),
    da_rx_antennas: Sequence[int] = (0, 3, 4, 7),
    num_angle_bins: int = 64,
    valid_angle_range: Sequence[float] = (np.deg2rad(-60), np.deg2rad(60)),
    chirp_idx: int = 0,
    da_shift_angle: bool = True,
    reformat_input: bool = True,
    device,
) -> SpectralMapsPipeline:
    """Build ``(raw_re, raw_im) -> SpectralMaps`` over a frame batch on ``device``.

    The signature mirrors the JAX package's.  For the standard geometry with
    virtual antennas the Doppler-azimuth sub-array is Hann-windowed over its
    antennas, as the reference does.  Calls :func:`set_full_fp32`.
    """
    return _build(SpectralMapsPipeline(
        cfg, rx_idx=rx_idx, ra_rx_antennas=ra_rx_antennas, da_rx_antennas=da_rx_antennas,
        num_angle_bins=num_angle_bins, valid_angle_range=valid_angle_range,
        chirp_idx=chirp_idx, da_shift_angle=da_shift_angle,
        reformat_input=reformat_input), device)


def build_micro_doppler_pipeline(
    cfg: RadarConfig,
    *,
    rx_idx: int = 0,
    target_ranges: Sequence[float] = (0.0, 1.0),
    num_frames_history: int = 20,
    reformat_input: bool = True,
    device,
) -> MicroDopplerPipeline:
    """Build ``(raw_re[T, ...], raw_im[T, ...]) -> spectrograms [T, vel, history]`` on ``device``.

    The frames are one recording in time order; output ``t`` is the
    spectrogram after frame ``t``, zeros before the first frame (reference
    ``micro_doppler_resp.py``: unwindowed 2D DFT, Doppler-only fftshift, max
    over the gated range rows, shift-register history).
    """
    return _build(MicroDopplerPipeline(
        cfg, rx_idx=rx_idx, target_ranges=target_ranges,
        num_frames_history=num_frames_history, reformat_input=reformat_input), device)


def build_strip_map_pipeline(
    cfg: RadarConfig,
    *,
    rx_index: int = 0,
    reformat_input: bool = True,
    device,
) -> StripMapPipeline:
    """Build ``(raw_re, raw_im) -> |SAR map| [B, ns, loops]`` (the full map) on ``device``.

    One windowless 2D DFT with a Doppler fftshift (reference
    ``strip_map_SAR_processor.py:181-189``); the velocity-dependent crop
    stays on the host, by ``processors.strip_map_sar.StripMapSARProcessor``'s
    slices.
    """
    return _build(StripMapPipeline(cfg, rx_index=rx_index,
                                   reformat_input=reformat_input), device)


@timed_builder("dbs")
def build_dbs_pipeline(
    cfg: RadarConfig,
    *,
    rx_antennas: Sequence[int] = (0, 3, 4, 7),
    num_angle_bins: int = 64,
    num_dbs_angle_bins: int = 100,
    min_x_y_vel_dbs: float = 0.25,
    chirp_idx: int = 0,
    reformat_input: bool = True,
    device,
) -> DBSPipeline:
    """Build ``(raw_re, raw_im, velocity_ned [B, 3]) -> [B, ns, n_dbs]`` on ``device``.

    Per frame: the DBS-sharpened map where ``|v_xy| >= min_x_y_vel_dbs``,
    else the plain range-angle map resampled to the DBS grid's nearest
    coarse angles (the reference's low-speed fallback).
    """
    return _build(DBSPipeline(
        cfg, rx_antennas=rx_antennas, num_angle_bins=num_angle_bins,
        num_dbs_angle_bins=num_dbs_angle_bins, min_x_y_vel_dbs=min_x_y_vel_dbs,
        chirp_idx=chirp_idx, reformat_input=reformat_input), device)
