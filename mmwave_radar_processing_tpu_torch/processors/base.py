"""Processor base (JAX: ``processors/base.py``): config-bound objects with host-side history.

The port's own copy of the JAX package's numpy base (the port imports
nothing of that package), plus the helpers every device-bound processor uses
to take its inputs to its device.

- configuration is an immutable :class:`RadarConfig` plus constants bound at
  construction;
- estimate/ground-truth histories live on the host in plain lists (they feed
  the analysis layer, never the device path).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``: the CPU, or CUDA when a CUDA device is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but no CUDA device is "
                           "available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def as_complex64(adc_cube, device: torch.device) -> torch.Tensor:
    """A complex cube (tensor or numpy, any complex width) as complex64 on ``device``."""
    if not isinstance(adc_cube, torch.Tensor):
        adc_cube = torch.from_numpy(np.array(adc_cube, np.complex64))
    return adc_cube.to(device, torch.complex64)


def as_float32(x, device: torch.device) -> torch.Tensor:
    """A real signal (tensor or numpy, any float width) as float32 on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device, torch.float32)


def to_host(value):
    """A result or attribute as a host array: a tensor (CUDA or CPU) is copied to numpy, anything else goes through ``np.asarray``; ``None`` stays ``None``.

    The one boundary where device results become host arrays: the viewer's
    payloads and every plotter go through it.  A numpy array comes back as
    it is, without a copy.
    """
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class Processor:
    """Config-bound processor with host-side history tracking."""

    def __init__(self, config: RadarConfig):
        if config.range_res_m <= 0:
            config = config.derive()
        self.config = config
        self.history_estimated: List[np.ndarray] = []
        self.history_gt: List[np.ndarray] = []

    def update_history(self, estimated=None, ground_truth=None) -> None:
        """Append one (estimate, ground truth) pair for later analysis."""
        if estimated is not None:
            self.history_estimated.append(np.asarray(estimated))
        if ground_truth is not None:
            self.history_gt.append(np.asarray(ground_truth))

    def reset(self) -> None:
        self.history_estimated = []
        self.history_gt = []
