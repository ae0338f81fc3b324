"""Point-cloud geometry (JAX: ``processors/point_cloud.py``)."""

from __future__ import annotations

import torch


def spherical_to_cartesian_flu(
    ranges: torch.Tensor, az: torch.Tensor, el: torch.Tensor, vel: torch.Tensor
) -> torch.Tensor:
    """``[..., K]`` spherical detections -> ``[..., K, 4]`` FLU ``(x, y, z, vel)``."""
    x = ranges * torch.cos(el) * torch.cos(az)
    y = ranges * torch.cos(el) * torch.sin(az)
    z = ranges * torch.sin(el)
    return torch.stack([x, y, z, vel], dim=-1)
