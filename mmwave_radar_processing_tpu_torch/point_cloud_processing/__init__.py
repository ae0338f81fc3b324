"""Point-cloud post-processing: ego velocity from radar points (JAX: ``point_cloud_processing/``).

RANSAC-robust least squares over ``(x, y, z, vel)`` detections, every trial
of a fit at once, with Gumbel scores drawn from a seeded generator.
"""

from mmwave_radar_processing_tpu_torch.point_cloud_processing.vehicle_vel_estimator import (
    VehicleVelEstimator,
)
from mmwave_radar_processing_tpu_torch.point_cloud_processing.vel_estimator import (
    VelocityEstimator,
    carry_passing,
    ego_vel_from_points,
    passes_gates,
)

__all__ = ["VelocityEstimator", "VehicleVelEstimator", "carry_passing", "ego_vel_from_points",
           "passes_gates"]
