"""Frame-batched point-cloud pipeline: raw cubes -> point clouds (JAX: ``parallel/pipeline.py``).

The port of ``build_point_cloud_pipeline`` with the ``union`` dataflow, the
main path of the system.  Per frame:

1. windowed range DFT of the AoA antenna union (plus channel 0), with the
   virtual-array reformat folded into the channel selection -> ``R``;
2. Doppler DFT of channel 0 and its magnitude -> the CFAR map;
3. counting OS-CFAR 2D detection and
4. compaction of the first ``max_dets`` detections, row-major (on a GPU one
   hand-written CUDA kernel does both: ``ops/cfar.os_2d_detect_compact``);
5. the detected cells' values on the union, gathered from ``R``;
6. azimuth and elevation from a zero-padded angle DFT and its argmax;
7. conversion to cartesian FLU points; invalid rows are zero.

The pipeline's state is its constants (DFT matrices, angle bins, antenna
layout, CFAR geometry); it has no learned weights and uses no randomness.
Precision is full float32 with TF32 off (:func:`set_full_fp32`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import dft
from mmwave_radar_processing_tpu_torch.ops.cfar import os_2d_detect_compact
from mmwave_radar_processing_tpu_torch.processors.base import resolve_device
from mmwave_radar_processing_tpu_torch.processors.point_cloud import (
    spherical_to_cartesian_flu,
)

DEFAULT_CFAR_PARAMS = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)

#: complex DFT buffers and the JAX ``(cos, sin)`` constant pair each is built from
_FACTOR_KEYS = {
    "rng_dft": ("rng_cos", "rng_sin"),
    "dop_dft": ("dop_cos", "dop_sin"),
    "az_dft": ("az_cos", "az_sin"),
    "el_dft": ("el_cos", "el_sin"),
}
#: structural constants: checked against the pipeline's own, never overwritten
_LAYOUT_KEYS = ("union_idx", "az_pos", "el_pos")


class PointCloudBatch(NamedTuple):
    points: torch.Tensor  # float32 [B, K, 4]
    valid: torch.Tensor  # bool [B, K]
    count: torch.Tensor  # int32 [B]


def set_full_fp32() -> None:
    """Full float32 matmuls: TF32 off for cuBLAS and cuDNN, precision "highest".

    These are process-wide PyTorch settings.  The pipeline's discrete
    decisions (CFAR comparisons, angle argmax) are held to a float32
    reference, and TF32 keeps only about three decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class PointCloudPipeline(nn.Module):
    """``(raw_re, raw_im) float32 [B, rx, ns, nc] -> PointCloudBatch``.

    With ``reformat_input=False`` the planes are already reformatted virtual
    cubes ``[B, virtual channels, ns, loops]``.  An empty antenna subset
    gives zero angles on that axis.  Build it with
    :func:`build_point_cloud_pipeline`, which checks the options and places
    it on a device.
    """

    def __init__(
        self,
        cfg: RadarConfig,
        *,
        az_antenna_idxs: Sequence[int],
        el_antenna_idxs: Sequence[int],
        cfar_params: dict,
        max_dets: int,
        num_angle_bins: int,
        shift_az_resp: bool,
        shift_el_resp: bool,
        reformat_input: bool = True,
    ):
        super().__init__()
        ns, loops = cfg.num_adc_samples, cfg.frame.loops
        self.num_rx, self.cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
        self.reformat_input = reformat_input
        self.frame_shape = (ns, loops * self.cpl) if reformat_input else (ns, loops)
        self.cfar_params = dict(cfar_params)
        self.max_dets = max_dets
        # affine bin grids (exact: the reference grids are arange-generated)
        self.range_res = cfg.range_res_m
        self.vel0, self.vel_res = -cfg.vel_max_m_s, cfg.vel_res_m_s

        # union of the antenna subsets; channel 0 (the CFAR map) is computed
        # whether or not the AoA union contains it
        az_idx = np.asarray(az_antenna_idxs, int)
        el_idx = np.asarray(el_antenna_idxs, int)
        self.has_az, self.has_el = bool(az_idx.size), bool(el_idx.size)
        self.union_idx, az_pos, el_pos, _ = dft.aoa_union_layout(az_idx, el_idx)
        if 0 in self.union_idx:
            chans = self.union_idx
            self.ch0_pos = int(np.searchsorted(self.union_idx, 0))
            self.aoa_start = 0
        else:
            chans = np.concatenate([[0], self.union_idx])
            self.ch0_pos, self.aoa_start = 0, 1
        # planes the input must hold: receivers of a raw cube, virtual channels
        # of a reformatted one
        self.min_planes = self.num_rx if reformat_input else int(chans.max()) + 1

        rng_factors, dop_factors = dft.range_doppler_factors(ns, loops)
        self.register_buffer("rng_dft", dft.to_matrix(rng_factors))
        self.register_buffer("dop_dft", dft.to_matrix(dop_factors))
        self.register_buffer("az_dft", dft.to_matrix(dft.aoa_factors(
            len(az_idx) or 1, num_angle_bins, shift_az_resp)))
        self.register_buffer("el_dft", dft.to_matrix(dft.aoa_factors(
            len(el_idx) or 1, num_angle_bins, shift_el_resp)))
        self.register_buffer("angle_bins", torch.from_numpy(
            grids.angle_bins(num_angle_bins).astype(np.float32)))
        self.register_buffer("chans", torch.from_numpy(chans.astype(np.int64)))
        self.register_buffer("az_pos", torch.from_numpy(az_pos.astype(np.int64)))
        self.register_buffer("el_pos", torch.from_numpy(el_pos.astype(np.int64)))

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor) -> PointCloudBatch:
        if raw_re.shape != raw_im.shape or raw_re.dim() != 4 \
                or tuple(raw_re.shape[-2:]) != self.frame_shape \
                or raw_re.shape[1] < self.min_planes:
            raise ValueError(
                f"expected planes [B, >={self.min_planes}, {self.frame_shape[0]}, "
                f"{self.frame_shape[1]}], got {tuple(raw_re.shape)} and "
                f"{tuple(raw_im.shape)}")
        for plane in (raw_re, raw_im):
            if plane.dtype != torch.float32:
                raise TypeError(f"expected float32 planes, got {plane.dtype}")
            if plane.device != self.rng_dft.device:
                raise ValueError(f"input on {plane.device}, pipeline on "
                                 f"{self.rng_dft.device}")

        raw = torch.complex(raw_re, raw_im)
        if self.reformat_input:
            R = dft.range_dft_channels(raw, self.chans, self.rng_dft,
                                       num_rx=self.num_rx, cfgs_per_loop=self.cpl)
        else:
            R = torch.matmul(self.rng_dft.transpose(0, 1), raw[:, self.chans])
        rd0 = torch.matmul(R[:, self.ch0_pos], self.dop_dft)  # [B, W, V]
        r_i, v_i, valid, count = os_2d_detect_compact(
            dft.cabs(rd0), self.max_dets, **self.cfar_params)

        az = el = torch.zeros(r_i.shape, dtype=torch.float32, device=r_i.device)
        if self.has_az or self.has_el:
            vals = dft.rd_values(R[:, self.aoa_start:], self.dop_dft, r_i, v_i)
        if self.has_az:
            az = dft.aoa_peak_angles(vals, self.az_pos, self.az_dft, self.angle_bins)
        if self.has_el:
            el = dft.aoa_peak_angles(vals, self.el_pos, self.el_dft, self.angle_bins)
        ranges = r_i.to(torch.float32) * self.range_res
        vels = self.vel0 + v_i.to(torch.float32) * self.vel_res
        pts = spherical_to_cartesian_flu(ranges, az, el, vels)
        pts = torch.where(valid[..., None], pts, 0.0)
        return PointCloudBatch(pts, valid, count)


def build_point_cloud_pipeline(
    cfg: RadarConfig,
    *,
    az_antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    el_antenna_idxs: Sequence[int] = (9, 8, 5, 4),
    cfar_params: Optional[dict] = None,
    max_dets: int = 128,
    num_angle_bins: int = 64,
    shift_az_resp: bool = True,
    shift_el_resp: bool = False,
    reformat_input: bool = True,
    backend: str = "mxu",
    aoa_precision: str = "f32",
    dataflow: str = "union",
    device,
) -> PointCloudPipeline:
    """Build the point-cloud pipeline on ``device`` (``"cpu"`` or ``"cuda[:n]"``).

    The signature mirrors the JAX package's.  Only what the port implements
    is accepted; the rest raises ``ValueError`` rather than running another
    path: ``backend`` is ``"mxu"`` (the DFT-as-matmul formulation),
    ``dataflow`` is ``"union"`` and ``aoa_precision`` is ``"f32"`` (the port
    has no reduced-precision mode; the result is held to the JAX ``"f32"``
    pipeline).  ``reformat_input=False`` takes already reformatted virtual
    cubes ``[B, virtual channels, ns, loops]``; an empty antenna subset gives
    zero angles on its axis.  Calls :func:`set_full_fp32`.
    """
    if backend != "mxu":
        raise ValueError(f"backend={backend!r} is not ported (only 'mxu')")
    if dataflow != "union":
        raise ValueError(f"dataflow={dataflow!r} is not ported (only 'union')")
    if not isinstance(reformat_input, bool):
        raise ValueError(f"reformat_input={reformat_input!r}: expected a bool")
    if aoa_precision != "f32":
        raise ValueError(f"aoa_precision={aoa_precision!r} is not ported: the "
                         "port runs full float32 only ('f32')")
    device = resolve_device(device)
    set_full_fp32()
    pipeline = PointCloudPipeline(
        cfg,
        az_antenna_idxs=az_antenna_idxs,
        el_antenna_idxs=el_antenna_idxs,
        cfar_params=cfar_params or DEFAULT_CFAR_PARAMS,
        max_dets=max_dets,
        num_angle_bins=num_angle_bins,
        shift_az_resp=shift_az_resp,
        shift_el_resp=shift_el_resp,
        reformat_input=reformat_input,
    )
    return pipeline.to(device)


def load_reference_constants(pipeline: PointCloudPipeline,
                             consts: Dict[str, np.ndarray]) -> None:
    """Fill the pipeline's constant buffers from the JAX package's constants.

    ``consts`` holds numpy arrays: the ``(cos, sin)`` factor pairs
    ``rng_cos``/``rng_sin`` and ``dop_cos``/``dop_sin``
    (``ops/mxu.range_doppler_factors``), ``az_cos``/``az_sin`` and
    ``el_cos``/``el_sin`` (``ops/mxu.aoa_factors``), and ``angle_bins``; plus
    the antenna layout ``union_idx``, ``az_pos`` and ``el_pos``
    (``ops/mxu.aoa_union_layout``), which must equal the pipeline's own.
    """
    expected = {k for pair in _FACTOR_KEYS.values() for k in pair}
    expected |= {"angle_bins", *_LAYOUT_KEYS}
    if set(consts) != expected:
        raise ValueError(f"constant names differ: missing "
                         f"{sorted(expected - set(consts))}, unknown "
                         f"{sorted(set(consts) - expected)}")
    layout = {"union_idx": pipeline.union_idx,
              "az_pos": pipeline.az_pos.cpu().numpy(),
              "el_pos": pipeline.el_pos.cpu().numpy()}
    for key, own in layout.items():
        if not np.array_equal(np.asarray(consts[key]), own):
            raise ValueError(f"{key} {np.asarray(consts[key])} differs from the "
                             f"pipeline's {own}")

    def f32(key):
        return torch.from_numpy(np.array(consts[key], np.float32))

    loaded = {buf: dft.to_matrix((f32(c), f32(s)))
              for buf, (c, s) in _FACTOR_KEYS.items()}
    loaded["angle_bins"] = f32("angle_bins")
    with torch.no_grad():
        for buf, value in loaded.items():
            target = getattr(pipeline, buf)
            if value.shape != target.shape:
                raise ValueError(f"{buf}: shape {tuple(value.shape)}, pipeline "
                                 f"has {tuple(target.shape)}")
            target.copy_(value)
