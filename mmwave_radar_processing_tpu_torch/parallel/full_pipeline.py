"""Combined serving pipeline: point clouds and ego-velocity per frame batch (JAX: ``parallel/full_pipeline.py``).

The configuration ``scripts/process_recording.py`` serves recordings with:
one call maps raw cubes and altitudes to ``(PointCloudBatch, VelocityBatch)``.
The point-cloud half is :class:`~.pipeline.PointCloudPipeline` (``union``
dataflow), the velocity half :class:`~.velocity_pipeline.VelocityPipeline`;
each runs as it does on its own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.parallel.pipeline import (
    PointCloudBatch,
    PointCloudPipeline,
    build_point_cloud_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.velocity_pipeline import (
    VelocityBatch,
    VelocityPipeline,
    build_velocity_pipeline,
)


class FullPipeline(nn.Module):
    """``(raw_re, raw_im, altitude) -> (PointCloudBatch, VelocityBatch)``."""

    def __init__(self, point_cloud: PointCloudPipeline, velocity: VelocityPipeline):
        super().__init__()
        self.point_cloud = point_cloud
        self.velocity = velocity

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor,
                altitude: torch.Tensor, *, gumbel: Optional[torch.Tensor] = None,
                ) -> Tuple[PointCloudBatch, VelocityBatch]:
        return (self.point_cloud(raw_re, raw_im),
                self.velocity(raw_re, raw_im, altitude, gumbel=gumbel))


def build_full_pipeline(
    cfg: RadarConfig,
    *,
    az_antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    el_antenna_idxs: Sequence[int] = (9, 8, 5, 4),
    cfar_params: Optional[dict] = None,
    max_dets: int = 128,
    num_angle_bins: int = 64,
    aoa_precision: str = "f32",
    shift_az_resp: bool = True,
    shift_el_resp: bool = False,
    velocity_kwargs: Optional[dict] = None,
    device,
) -> FullPipeline:
    """Build the combined pipeline on ``device``; the signature mirrors the JAX package's.

    ``aoa_precision`` is ``"f32"`` only (the port's one precision; the JAX
    default ``"fast"`` and ``"exact"`` raise).  ``velocity_kwargs`` go to
    :func:`build_velocity_pipeline`.
    """
    point_cloud = build_point_cloud_pipeline(
        cfg, az_antenna_idxs=az_antenna_idxs, el_antenna_idxs=el_antenna_idxs,
        cfar_params=cfar_params, max_dets=max_dets, num_angle_bins=num_angle_bins,
        shift_az_resp=shift_az_resp, shift_el_resp=shift_el_resp,
        aoa_precision=aoa_precision, device=device)
    velocity = build_velocity_pipeline(cfg, device=device, **(velocity_kwargs or {}))
    return FullPipeline(point_cloud, velocity)
