"""The point-cloud stages that the batched pipelines share, each defined once.

The input contract of the raw planes (:func:`check_planes`), the antenna
union of a point-cloud front (:func:`antenna_union`) and the angle head that
turns detections into FLU points (:class:`AngleHead`).  The range DFT with
the virtual-array reformat folded in is ``ops.dft.range_dft_input``.  The
point-cloud and ground pipelines call all of these; the viewer's ``det2d``
group calls the head on every virtual channel.  On the card the head is one
launch of a hand-written kernel (``csrc/aoa_head.cu``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import dft
from mmwave_radar_processing_tpu_torch.ops.kernels import aoa_head as aoa_kernel
from mmwave_radar_processing_tpu_torch.processors.point_cloud import (
    spherical_to_cartesian_flu,
)


def check_planes(raw_re: torch.Tensor, raw_im: torch.Tensor, *, frame_shape,
                 min_planes: int, device: torch.device) -> None:
    """Raise unless the planes are float32 ``[B, >=min_planes, *frame_shape]`` on ``device``."""
    if raw_re.shape != raw_im.shape or raw_re.dim() != 4 \
            or tuple(raw_re.shape[-2:]) != tuple(frame_shape) \
            or raw_re.shape[1] < min_planes:
        raise ValueError(f"expected planes [B, >={min_planes}, {frame_shape[0]}, "
                         f"{frame_shape[1]}], got {tuple(raw_re.shape)} and "
                         f"{tuple(raw_im.shape)}")
    for plane in (raw_re, raw_im):
        if plane.dtype != torch.float32:
            raise TypeError(f"expected float32 planes, got {plane.dtype}")
        if plane.device != device:
            raise ValueError(f"input on {plane.device}, pipeline on {device}")


class AntennaUnion(NamedTuple):
    union_idx: np.ndarray  # sorted union of the two subsets
    chans: np.ndarray  # the channels transformed: the union, channel 0 first
    ch0_pos: int  # channel 0's position in chans
    aoa_start: int  # where the union starts in chans
    az_pos: np.ndarray  # each subset's positions within the union
    el_pos: np.ndarray
    min_planes: int  # planes the input must hold


def antenna_union(az_antenna_idxs: Sequence[int], el_antenna_idxs: Sequence[int], *,
                  reformat_input: bool, num_rx: int) -> AntennaUnion:
    """The channel layout of a point-cloud front.

    Channel 0 (the CFAR map) is transformed whether or not the union holds
    it.  A raw cube must hold ``num_rx`` receivers; a reformatted one every
    virtual channel up to the largest transformed.
    """
    union_idx, az_pos, el_pos, _ = dft.aoa_union_layout(az_antenna_idxs, el_antenna_idxs)
    if 0 in union_idx:
        chans, ch0_pos, aoa_start = union_idx, int(np.searchsorted(union_idx, 0)), 0
    else:
        chans, ch0_pos, aoa_start = np.concatenate([[0], union_idx]), 0, 1
    min_planes = num_rx if reformat_input else int(chans.max()) + 1
    return AntennaUnion(union_idx, chans, ch0_pos, aoa_start, az_pos, el_pos, min_planes)


class AngleHead(nn.Module):
    """``(R, dop, r_i, v_i, valid) -> float32 [B, K, 4]`` FLU points ``(x, y, z, vel)``.

    ``R`` is a range-transformed cube ``complex64 [B, A, W, L]`` and ``dop``
    its Doppler DFT matrix; ``az_pos`` and ``el_pos`` index ``R``'s channel
    axis.  An empty position set gives zero angles on its axis; a slot whose
    ``valid`` is False gives 0.  The head's state is its constants: the
    angle DFT matrices ``az_dft``/``el_dft``, the bin angles ``angle_bins``
    and the positions.

    Dispatches on the device of ``R``: a CPU tensor takes the plain version
    (:meth:`plain`), any other the hand-written CUDA kernel
    (:mod:`..ops.kernels.aoa_head`), which reads only the filled slots' rows,
    or raises.  There is no fallback from one to the other.
    """

    def __init__(self, cfg: RadarConfig, *, az_pos: Sequence[int], el_pos: Sequence[int],
                 num_angle_bins: int, shift_az_resp: bool, shift_el_resp: bool):
        super().__init__()
        az_pos, el_pos = np.asarray(az_pos, int), np.asarray(el_pos, int)
        self.has_az, self.has_el = bool(az_pos.size), bool(el_pos.size)
        # the kernel's positions, on the host
        self.positions = tuple(int(p) for p in az_pos), tuple(int(p) for p in el_pos)
        # affine bin grids (exact: the reference grids are arange-generated)
        self.range_res = cfg.range_res_m
        self.vel0, self.vel_res = -cfg.vel_max_m_s, cfg.vel_res_m_s
        self.register_buffer("az_dft", dft.to_matrix(dft.aoa_factors(
            len(az_pos) or 1, num_angle_bins, shift_az_resp)))
        self.register_buffer("el_dft", dft.to_matrix(dft.aoa_factors(
            len(el_pos) or 1, num_angle_bins, shift_el_resp)))
        self.register_buffer("angle_bins", torch.from_numpy(
            grids.angle_bins(num_angle_bins).astype(np.float32)))
        self.register_buffer("az_pos", torch.from_numpy(az_pos.astype(np.int64)))
        self.register_buffer("el_pos", torch.from_numpy(el_pos.astype(np.int64)))

    def forward(self, R: torch.Tensor, dop: torch.Tensor, r_i: torch.Tensor,
                v_i: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if R.device.type == "cpu":
            return self.plain(R, dop, r_i, v_i, valid)
        az_pos, el_pos = self.positions
        return aoa_kernel.aoa_head(
            R, dop, r_i, v_i, valid, az_pos=az_pos, el_pos=el_pos, az_dft=self.az_dft,
            el_dft=self.el_dft, angle_bins=self.angle_bins, range_res=self.range_res,
            vel0=self.vel0, vel_res=self.vel_res)

    def plain(self, R: torch.Tensor, dop: torch.Tensor, r_i: torch.Tensor,
              v_i: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The plain version: every slot's rows gathered, the angle spectra, the points, then the mask."""
        az = el = torch.zeros(r_i.shape, dtype=torch.float32, device=r_i.device)
        if self.has_az or self.has_el:
            vals = dft.rd_values(R, dop, r_i, v_i)  # [B, A, K]
        if self.has_az:
            az = dft.aoa_peak_angles(vals, self.az_pos, self.az_dft, self.angle_bins)
        if self.has_el:
            el = dft.aoa_peak_angles(vals, self.el_pos, self.el_dft, self.angle_bins)
        ranges = r_i.to(torch.float32) * self.range_res
        vels = self.vel0 + v_i.to(torch.float32) * self.vel_res
        pts = spherical_to_cartesian_flu(ranges, az, el, vels)
        return torch.where(valid[..., None], pts, 0.0)
