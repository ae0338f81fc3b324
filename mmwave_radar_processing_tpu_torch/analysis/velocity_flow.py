"""The per-frame ego-velocity analysis flow over a recording (JAX: the loop of ``scripts/test_vel_estimation.py``).

Raw ADC frame -> ``VirtualArrayReformatter`` -> ground-gated point cloud
(``PointCloudGenerator``) -> points ``VelocityEstimator`` -> the estimate and
the odometry's ground truth, both turned by the configuration's frame
matrices.  ``params`` is an analyzer configuration as parsed from YAML
(``analyzer_configs/velocity_analysis_config.yaml``: ``processors``,
``analysis``, ``transformation``); parsing it is the caller's business, so
this module needs no YAML package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_tpu_torch.point_cloud_processing import VelocityEstimator
from mmwave_radar_processing_tpu_torch.processors.point_cloud import PointCloudGenerator
from mmwave_radar_processing_tpu_torch.processors.virtual_array import VirtualArrayReformatter


def build_estimator(cfg: RadarConfig, params: dict, *, device) -> VelocityEstimator:
    """The points estimator with the configuration's gates (defaults 0.6 and 0.75)."""
    ve_params = params["processors"].get("velocity_estimator", {})
    return VelocityEstimator(cfg, min_R2_threshold=ve_params.get("min_r2_threshold", 0.6),
                             min_inlier_percent=ve_params.get("min_inlier_percent", 0.75),
                             device=device)


def analyze_velocity(
    dataset: CpslDS,
    cfg: RadarConfig,
    params: dict,
    *,
    device,
    start: Optional[int] = None,
    end: Optional[int] = None,
    estimator: Optional[VelocityEstimator] = None,
    logger=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Estimated and ground-truth velocities ``(N, 3)`` of frames ``[start, end)``, frame by frame.

    ``start`` and ``end`` default to the configuration's ``analysis``
    indices, the end clipped to the recording.  ``estimator``: a points
    ``VelocityEstimator`` to use in place of :func:`build_estimator`'s (e.g.
    one whose Gumbel draws are handed in).
    """
    reformatter = VirtualArrayReformatter(cfg, device=device)
    generator = PointCloudGenerator(cfg, **params["processors"]["point_cloud_generator"],
                                    device=device)
    if estimator is None:
        estimator = build_estimator(cfg, params, device=device)
    trans = params.get("transformation", {})
    uav_mat = np.asarray(trans.get("uav_vel_matrix", np.eye(3)))
    gt_mat = np.asarray(trans.get("gt_vel_matrix", np.eye(3)))
    analysis = params.get("analysis", {})
    if start is None:
        start = analysis.get("start_idx", 0)
    if end is None:
        end = min(analysis.get("end_idx", dataset.num_frames), dataset.num_frames)

    ests, gts = [], []
    for i in range(start, end):
        points = generator.process(reformatter.process(dataset.get_radar_adc_data(i)))
        vel = estimator.process(points=points)
        gt = np.mean(dataset.get_vehicle_odom_data(i)[:, 8:11], axis=0)
        ests.append(uav_mat @ vel)
        gts.append(gt_mat @ gt)
        estimator.update_history(ests[-1], gts[-1])
        if logger is not None and (i - start) % 50 == 0:
            logger.info("frame %d/%d vel=%s", i, end, np.round(ests[-1], 3))
    return np.array(ests).reshape(-1, 3), np.array(gts).reshape(-1, 3)
