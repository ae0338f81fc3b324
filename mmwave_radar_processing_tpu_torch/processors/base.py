"""Processor base (JAX: ``processors/base.py``): config-bound objects with host-side history.

A copy of the JAX package's 42-line numpy base.  It cannot be imported from
there: ``mmwave_radar_processing_tpu/processors/__init__.py`` imports every
processor and so imports JAX.

- configuration is an immutable :class:`RadarConfig` plus constants bound at
  construction;
- estimate/ground-truth histories live on the host in plain lists (they feed
  the analysis layer, never the device path).
"""

from __future__ import annotations

from typing import List

import numpy as np

from mmwave_radar_processing_tpu.config import RadarConfig


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
