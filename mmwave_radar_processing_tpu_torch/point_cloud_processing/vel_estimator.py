"""Points-based ego-velocity estimator (JAX: ``point_cloud_processing/vel_estimator.py``).

The RadVel estimator of the analysis scripts: RANSAC fits ``-vel = (p/|p|) .
v`` over the point cloud, 2D (x, y) for the standard geometry and 3D for
the ODS one, and keeps the last estimate that passes both gates (reference
:172-181).  Takes a plain ``(N, 4)`` array or a fixed-capacity padded
``(points, valid)`` pair, as a pipeline emits it.

The gates are written once, in :func:`passes_gates`; :func:`carry_passing`
applies them to a recording's fits at once, as the per-frame estimator's
``update_and_check_current_vel_measurements`` does frame after frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.ops import ransac
from mmwave_radar_processing_tpu_torch.processors.base import Processor, resolve_device

MAX_TRIALS = 20


def ego_vel_from_points(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    dims: int,
    min_samples: int = 10,
    residual_threshold: float = 0.15,
    max_trials: int = MAX_TRIALS,
    scores: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> ransac.RansacResult:
    """RANSAC ego velocity from padded ``float32 [..., K, 4]`` points (reference :76-170).

    ``dims=2`` fits ``(vx, vy)`` from ``(x, y)``; ``dims=3`` also ``vz``.
    ``scores`` (``[..., max_trials, K]``) or ``generator`` as for
    :func:`..ops.ransac.ransac_linear`.
    """
    p = points[..., :dims]
    norm = torch.sqrt((p * p).sum(dim=-1, keepdim=True))
    h = p / torch.clamp_min(norm, 1e-12)
    return ransac.ransac_linear(
        h, -points[..., 3], valid, min_samples=min_samples,
        residual_threshold=residual_threshold, max_trials=max_trials,
        scores=scores, generator=generator)


def passes_gates(r2, inlier_fraction, min_r2_threshold: float, min_inlier_percent: float):
    """The estimator's gates (reference :172-181): R^2 and the inlier share each at least its threshold.

    Floats give a bool, tensors a bool tensor.
    """
    return (r2 >= min_r2_threshold) & (inlier_fraction >= min_inlier_percent)


def carry_passing(
    proposed: torch.Tensor, r2: torch.Tensor, inlier_fraction: torch.Tensor,
    init: torch.Tensor, *, min_r2_threshold: float, min_inlier_percent: float,
):
    """The estimate a recording's frames keep: each frame's last passing proposal at or before it.

    ``proposed`` ``float32 [T, 3]``, ``r2`` and ``inlier_fraction`` ``[T]``
    of frames in time order, and ``init`` ``[3]``, the estimate before the
    first frame.  Returns ``(carried [T, 3], final [3])``: a frame's carried
    estimate is the proposal of the last frame at or before it that
    :func:`passes_gates`, else ``init``; ``final`` is the last frame's (or
    ``init``), the carry of a chunked recording.  A prefix maximum over the
    frame indices, on the device and without a host sync.
    """
    n = proposed.shape[0]
    init = init.to(device=proposed.device, dtype=proposed.dtype)
    if n == 0:
        return proposed, init.clone()
    ok = passes_gates(r2, inlier_fraction, min_r2_threshold, min_inlier_percent)
    frames = torch.arange(n, device=proposed.device)
    last = torch.cummax(torch.where(ok, frames, -1), dim=0).values
    carried = torch.where((last >= 0)[:, None], proposed[last.clamp_min(0)], init)
    return carried, carried[-1]


class VelocityEstimator(Processor):
    """Points-only ego-velocity estimator with R^2 and inlier gates, on an explicit ``device``.

    Its Gumbel scores come from a CPU ``torch.Generator`` seeded with
    ``seed``, all drawn in :meth:`_draw_scores`.  On a CUDA device a cloud
    of more points than the RANSAC kernel takes (``ops.kernels.ransac_fit.takes``)
    raises.
    """

    def __init__(self, config: RadarConfig, min_R2_threshold: float = 0.6,
                 min_inlier_percent: float = 0.75, seed: int = 42, *, device, **kwargs):
        super().__init__(config)
        self.device = resolve_device(device)
        self.min_R2_threshold = min_R2_threshold
        self.min_inlier_percent = min_inlier_percent
        self._generator = torch.Generator().manual_seed(seed)
        self.estimated_R2 = 0.0
        self.inlier_percent = 0.0
        self.proposed_velocity_estimate = np.empty(0)
        self.current_velocity_estimate = np.array([0.0, 0.0, 0.0])
        self.history_R2_statistics = []
        self.history_inlier_statistics = []

    def _draw_scores(self, n: int, trials: int = MAX_TRIALS) -> torch.Tensor:
        """Gumbel scores ``float32 [trials, n]`` of one fit, drawn on the CPU, moved to the device."""
        return ransac.gumbel((trials, n), self._generator).to(self.device)

    def estimate_ego_velocity_points(self, points, valid=None):
        dims = 2 if self.config.array_geometry == "standard" else 3
        points = np.asarray(points.cpu() if isinstance(points, torch.Tensor) else points,
                            float)
        if valid is None:
            valid = np.ones(points.shape[0], bool)
        elif isinstance(valid, torch.Tensor):
            valid = valid.cpu().numpy()
        res = ego_vel_from_points(
            torch.as_tensor(points, dtype=torch.float32, device=self.device),
            torch.as_tensor(np.asarray(valid, bool), device=self.device), dims=dims,
            scores=self._draw_scores(points.shape[0]))
        self.estimated_R2 = float(res.r2)
        self.inlier_percent = float(res.inlier_fraction)
        vel = res.coef.cpu().numpy()
        if dims == 2:
            self.proposed_velocity_estimate = np.array([vel[0], vel[1], 0.0])
        else:
            self.proposed_velocity_estimate = vel

    def update_and_check_current_vel_measurements(self):
        """Keep the last estimate unless the new one passes both gates."""
        if passes_gates(self.estimated_R2, self.inlier_percent, self.min_R2_threshold,
                        self.min_inlier_percent):
            self.current_velocity_estimate = self.proposed_velocity_estimate.copy()

    def update_history(self, estimated=None, ground_truth=None):
        self.history_R2_statistics.append(self.estimated_R2)
        self.history_inlier_statistics.append(self.inlier_percent)
        super().update_history(estimated, ground_truth)

    def process(self, points: Optional[np.ndarray] = None, valid=None, **kwargs):
        """Velocity estimate ``[vx, vy, vz]`` (reference ``process`` :215-243)."""
        if points is not None and (points.numel() if isinstance(points, torch.Tensor)
                                   else np.size(points)) > 0:
            self.estimate_ego_velocity_points(points, valid)
        self.update_and_check_current_vel_measurements()
        return self.current_velocity_estimate

    def reset(self):
        self.history_R2_statistics = []
        self.history_inlier_statistics = []
        super().reset()
