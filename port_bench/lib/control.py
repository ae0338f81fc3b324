"""The control: the plain reference in the program's place, computed in TF32.

TF32 is the next precision below the deployments' float32 with TF32 off.
:class:`ReferencePipeline` takes a frame-batched pipeline's arguments and
returns outputs with the same fields, so a traffic kind drives it through
its timed path unchanged; its numbers against the float32 reference are the
upper readings the check's limits are set below.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference import pointcloud as ref_pc
from port_bench.reference import velocity as ref_vel


class Cloud(NamedTuple):
    points: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


class Estimate(NamedTuple):
    velocity: torch.Tensor
    vx: torch.Tensor
    az_r2: torch.Tensor
    el_r2: torch.Tensor
    az_inlier: torch.Tensor
    el_inlier: torch.Tensor


class ReferencePipeline:
    """The reference as a ``pointcloud`` or ``combined`` pipeline, at ``tf32`` or not."""

    def __init__(self, cell, kind: str, tf32: bool = True):
        self.radar, self.p, self.kind, self.tf32 = cell.radar, cell.config["processing"], kind, tf32

    def __call__(self, raw_re, raw_im, altitude=None, *, gumbel=None):
        c = ref_pc.point_cloud(raw_re, raw_im, self.radar, self.p, tf32=self.tf32)
        cloud = Cloud(c.points, c.valid, c.count.to(torch.int32))
        if self.kind == "pointcloud":
            return cloud
        v = ref_vel.velocity(raw_re, raw_im, altitude, gumbel, self.radar, self.p, tf32=self.tf32)
        return cloud, Estimate(v.velocity, v.velocity[:, 2], *v.fit.unbind(-1))
