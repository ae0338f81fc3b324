"""Analysis layer of the port: error statistics and the per-frame velocity-analysis flow.

- ``analyzers``     — ``BaseAnalyzer`` and ``VelocityAnalyzer`` (JAX:
                      ``analysis/analyzers.py``; numpy, pandas only inside
                      ``generate_report``).
- ``velocity_flow`` — ``analyze_velocity``: raw frames of a recording to
                      estimated and ground-truth ego velocities.
"""

from mmwave_radar_processing_tpu_torch.analysis.analyzers import BaseAnalyzer, VelocityAnalyzer
from mmwave_radar_processing_tpu_torch.analysis.velocity_flow import (
    analyze_velocity,
    build_estimator,
)

__all__ = ["BaseAnalyzer", "VelocityAnalyzer", "analyze_velocity", "build_estimator"]
