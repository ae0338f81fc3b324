"""RadVel's velocity analysis over a recording: the ground scan, then the points' ego velocity.

Upstream's ``scripts/test_vel_estimation.py`` at
``analyzer_configs/velocity_analysis_config.yaml``: per frame the
``RangeDopplerGroundDetector`` (the tracked altimeter, the altitude-gated
1D OS-CFAR) and the angle head give a point cloud, and the points
``VelocityEstimator`` fits the ego velocity to it by RANSAC, gates the fit
on R^2 and the inlier share and keeps the last estimate that passed.  Here
the whole recording goes through in one call, as a composition:

1. :class:`~.ground_pipeline.GroundPipeline` over the frames, the altitude
   carried from frame to frame;
2. ``point_cloud_processing.ego_vel_from_points`` batched over the frames'
   padded clouds ``[T, max_dets, 4]``, 3D for the ODS geometry and 2D
   ``(x, y)`` for the standard one, on the RANSAC draws the caller hands in
   (``scores [T, max_trials, max_dets]``);
3. ``point_cloud_processing.carry_passing``: the gates and the carried
   estimate, the second state carried from frame to frame.

A recording cut into chunks and chained through ``final_altitude`` and
``final_velocity`` gives what one call gives.  A call reads nothing back to
the host.  Its span is ``mmw.gnd``, around the ground scan's stages and
``mmw.gnd.vel`` (the RANSAC, the gates and the carry).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.parallel.ground_pipeline import (
    GroundPipeline,
    build_ground_point_cloud_pipeline,
)
from mmwave_radar_processing_tpu_torch.point_cloud_processing.vel_estimator import (
    carry_passing,
    ego_vel_from_points,
)
from mmwave_radar_processing_tpu_torch.utils.profiling import annotate, timed_builder


class VelocityAnalysisOut(NamedTuple):
    points: torch.Tensor  # float32 [T, K, 4]
    valid: torch.Tensor  # bool [T, K]
    count: torch.Tensor  # int32 [T]
    altitude: torch.Tensor  # float32 [T]: tracked altitude + range_bias
    proposed: torch.Tensor  # float32 [T, 3]: each frame's fit (vz 0 in 2D)
    r2: torch.Tensor  # float32 [T]
    inlier_fraction: torch.Tensor  # float32 [T]
    velocity: torch.Tensor  # float32 [T, 3]: the carried estimate
    final_altitude: torch.Tensor  # float32 []: the carries of a chunked recording
    final_velocity: torch.Tensor  # float32 [3]


class VelocityAnalysisPipeline(nn.Module):
    """``(raw_re, raw_im) float32 [T, rx, ns, nc], scores -> VelocityAnalysisOut`` over one recording.

    The frames are in time order.  ``forward(..., init_altitude=,
    init_velocity=)`` starts the altimeter at an altitude (a float or a
    scalar tensor; ``min_altitude_m`` by default) and the carried estimate
    at a velocity (``[3]``; zeros by default), such as the previous chunk's
    ``final_altitude`` and ``final_velocity``.  Build it with
    :func:`build_velocity_analysis_pipeline`.
    """

    def __init__(self, ground: GroundPipeline, *, dims: int, min_r2_threshold: float,
                 min_inlier_percent: float, min_samples: int, residual_threshold: float,
                 max_trials: int):
        super().__init__()
        self.ground = ground
        self.dims = dims
        self.min_r2_threshold = float(min_r2_threshold)
        self.min_inlier_percent = float(min_inlier_percent)
        self.ransac = dict(min_samples=int(min_samples),
                           residual_threshold=float(residual_threshold),
                           max_trials=int(max_trials))

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor, *, scores: torch.Tensor,
                init_altitude=None, init_velocity: Optional[torch.Tensor] = None,
                ) -> VelocityAnalysisOut:
        with annotate("mmw.gnd"):
            g = self.ground.scan(raw_re, raw_im, init_altitude)
            with annotate("mmw.gnd.vel"):
                fit = ego_vel_from_points(g.points, g.valid, dims=self.dims, scores=scores,
                                          **self.ransac)
                proposed = fit.coef
                if self.dims == 2:
                    proposed = torch.nn.functional.pad(proposed, (0, 1))
                init = (torch.zeros(3, dtype=torch.float32, device=proposed.device)
                        if init_velocity is None else init_velocity.reshape(3))
                carried, final = carry_passing(
                    proposed, fit.r2, fit.inlier_fraction, init,
                    min_r2_threshold=self.min_r2_threshold,
                    min_inlier_percent=self.min_inlier_percent)
        return VelocityAnalysisOut(g.points, g.valid, g.count, g.altitude, proposed, fit.r2,
                                   fit.inlier_fraction, carried, g.final_altitude, final)


@timed_builder("velocity_analysis")
def build_velocity_analysis_pipeline(
    cfg: RadarConfig,
    *,
    az_antenna_idxs: Sequence[int],
    el_antenna_idxs: Sequence[int],
    vel_cfar_params: dict,
    min_altitude_m: float,
    zoom_search_region_m: float,
    altitude_search_limit_m: float,
    range_bias: float,
    precise_est_enabled: bool,
    max_dets: int,
    num_angle_bins: int,
    shift_az_resp: bool,
    shift_el_resp: bool,
    min_r2_threshold: float,
    min_inlier_percent: float,
    min_samples: int = 10,
    residual_threshold: float = 0.15,
    max_trials: int = 20,
    reformat_input: bool = True,
    device,
) -> VelocityAnalysisPipeline:
    """Build the velocity analysis on ``device`` (``"cpu"`` or ``"cuda[:n]"``).

    The ground scan's arguments are :func:`build_ground_point_cloud_pipeline`'s;
    ``max_dets`` should hold every detection of a frame, as upstream keeps
    them all.  ``min_r2_threshold`` and ``min_inlier_percent`` are the
    estimator's gates, ``min_samples``, ``residual_threshold`` (m/s) and
    ``max_trials`` its RANSAC's (upstream's sklearn settings by default).
    The fit is 3D for the ODS geometry and 2D for the standard one.  On a
    CUDA device it is the RANSAC kernel's, which takes ``max_dets`` and
    ``max_trials`` within :func:`..ops.kernels.ransac_fit.takes` (up to 2048
    slots at 20 trials) and raises past them.
    """
    ground = build_ground_point_cloud_pipeline(
        cfg, az_antenna_idxs=az_antenna_idxs, el_antenna_idxs=el_antenna_idxs,
        vel_cfar_params=vel_cfar_params, min_altitude_m=min_altitude_m,
        zoom_search_region_m=zoom_search_region_m,
        altitude_search_limit_m=altitude_search_limit_m, range_bias=range_bias,
        precise_est_enabled=precise_est_enabled, max_dets=max_dets,
        num_angle_bins=num_angle_bins, shift_az_resp=shift_az_resp,
        shift_el_resp=shift_el_resp, reformat_input=reformat_input, device=device)
    dims = 2 if cfg.array_geometry == "standard" else 3
    return VelocityAnalysisPipeline(
        ground, dims=dims, min_r2_threshold=min_r2_threshold,
        min_inlier_percent=min_inlier_percent, min_samples=min_samples,
        residual_threshold=residual_threshold, max_trials=max_trials)
