"""RANSAC vehicle-velocity estimator with every trial at once (JAX: ``point_cloud_processing/vehicle_vel_estimator.py``).

The reference runs up to ``max_iters`` trials one after another: sample,
closed-form least squares, grow the inliers, refit, keep the lowest mean
squared error.  Here all trials are one batch of tiny normal-equation
solves, and the winner is the lowest-error trial among those with more than
``num_close_pts`` inliers, the reference's acceptance rule (:236-262).  A
static-object prefilter drops detections whose velocity disagrees with the
environment velocity an initial ego estimate predicts (:151-175).
"""

from __future__ import annotations

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops import ransac
from mmwave_radar_processing_tpu_torch.processors.base import resolve_device


def _lsq(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted normal equations with a relative ridge: ``[T, N, D], [N], [T, N] -> [T, D]``."""
    hw = h * w[..., None]
    a = hw.transpose(-1, -2) @ h
    b = (hw * y[..., None]).sum(dim=-2)
    d = a.shape[-1]
    ridge = 1e-7 * (torch.diagonal(a, dim1=-2, dim2=-1).sum(dim=-1) / d + 1e-30)
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    return torch.linalg.solve(a + ridge[..., None, None] * eye, b)


def ransac_trials(points: torch.Tensor, valid: torch.Tensor, scores: torch.Tensor, *,
                  points_per_fit: int, dims: int, fit_thresh: float,
                  num_close_pts: int):
    """Every trial at once: ``(best_fit [dims], best_error [], found [])``.

    ``points``: ``float32 [N, 4]``; ``scores``: ``float32 [trials, N]``
    Gumbel scores, whose ``points_per_fit`` largest among the valid rows seed
    each trial.  The first trial of the lowest error wins.
    """
    p = points[:, :dims]
    h = p / torch.clamp_min(torch.sqrt((p * p).sum(dim=1, keepdim=True)), 1e-12)
    y = points[:, 3]
    validf = valid.to(torch.float32)
    s = torch.where(valid, scores, float("-inf"))
    idx = torch.topk(s, points_per_fit, dim=-1).indices
    w_seed = torch.zeros_like(s).scatter_(-1, idx, 1.0) * validf
    coef = _lsq(h, y, w_seed)  # [T, D]
    sq_err = (y - coef @ h.T) ** 2
    # grow: the seed rows and every other valid row under the fit threshold
    grown = (w_seed > 0) | ((sq_err < fit_thresh) & valid)
    n_in = grown.sum(dim=-1)
    w_grown = grown.to(torch.float32)
    refit = _lsq(h, y, w_grown)
    mse = (w_grown * (y - refit @ h.T) ** 2).sum(dim=-1) / torch.clamp_min(n_in, 1)
    errors = torch.where(n_in > num_close_pts, mse, float("inf"))
    best = torch.argmin(errors)
    return refit[best], errors[best], torch.isfinite(errors[best])


class VehicleVelEstimator:
    """Ego-vehicle velocity by parallel-trial RANSAC over detections, on an explicit ``device``.

    Gumbel scores come from a CPU ``torch.Generator`` seeded with ``seed``,
    all drawn in :meth:`_draw_scores`.
    """

    def __init__(self, points_per_fit: int = 7, max_iters: int = 100,
                 fit_thresh: float = 0.05, num_close_pts: int = 10,
                 static_vel_thresh: float = 0.2, seed: int = 0, *, device):
        self.device = resolve_device(device)
        self.points_per_fit = points_per_fit
        self.max_iters = max_iters
        self.fit_thresh = fit_thresh
        self.num_close_pts = num_close_pts
        self.static_vel_thresh = static_vel_thresh
        self.best_fit = None
        self.best_error = np.inf
        self._generator = torch.Generator().manual_seed(seed)

    # reference-compatible helpers -------------------------------------- #
    @staticmethod
    def lsq_fit_2D(detections: np.ndarray, only_2D: bool = True) -> np.ndarray:
        """Closed-form least-squares environment velocity (reference :47-80)."""
        p = detections[:, 0:2] if only_2D else detections[:, 0:3]
        y = detections[:, 3]
        h = p / np.linalg.norm(p, axis=1, keepdims=True)
        return np.linalg.inv(h.T @ h) @ h.T @ y

    @staticmethod
    def lsq_predict(detections: np.ndarray, v: np.ndarray) -> np.ndarray:
        p = detections[:, 0:v.shape[0]]
        h = p / np.linalg.norm(p, axis=1, keepdims=True)
        return h @ v

    @staticmethod
    def square_error_loss(v_true, v_pred):
        return (v_true - v_pred) ** 2

    def mean_square_error(self, v_true, v_pred):
        return float(np.sum(self.square_error_loss(v_true, v_pred)) / v_true.shape[0])

    def get_static_detections(self, detections: np.ndarray, ego_vel: np.ndarray):
        """Detections consistent with the environment velocity ``-ego_vel`` predicts."""
        v_pred = self.lsq_predict(detections, -np.asarray(ego_vel))
        errors = self.square_error_loss(detections[:, 3], v_pred)
        return detections[errors < self.static_vel_thresh, :]

    # ------------------------------------------------------------------ #
    def _draw_scores(self, n: int) -> torch.Tensor:
        """Gumbel scores ``float32 [max_iters, n]`` of one estimate, drawn on the CPU."""
        return ransac.gumbel((self.max_iters, n), self._generator).to(self.device)

    def estimate_ego_vel(self, detections: np.ndarray,
                         initial_ego_vel_est: np.ndarray = np.empty(0),
                         only_2D: bool = True) -> np.ndarray:
        """Best ``[vx, vy]`` (or ``[vx, vy, vz]``) ego velocity, or an empty array."""
        detections = np.asarray(detections, float)
        if detections.shape[0] < self.num_close_pts:
            return np.empty(0)
        if initial_ego_vel_est.shape[0] > 0:
            detections = self.get_static_detections(detections, initial_ego_vel_est)
            if detections.shape[0] < self.num_close_pts:
                return np.empty(0)
        n = detections.shape[0]
        fit, err, found = ransac_trials(
            torch.as_tensor(detections, dtype=torch.float32, device=self.device),
            torch.ones(n, dtype=torch.bool, device=self.device), self._draw_scores(n),
            points_per_fit=self.points_per_fit, dims=2 if only_2D else 3,
            fit_thresh=self.fit_thresh, num_close_pts=self.num_close_pts)
        if not bool(found):
            self.best_error = np.inf
            return np.empty(0)
        self.best_fit = fit.cpu().numpy()
        self.best_error = float(err)
        return -self.best_fit  # environment velocity -> ego velocity

    def get_vehicle_vel_est(self):
        return -self.best_fit
