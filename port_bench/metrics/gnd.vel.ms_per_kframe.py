"""The velocity analysis's vel stage: device ms per 1024 frames of ``mmw.gnd.vel``.

``parallel/velocity_analysis_pipeline.py``: the points' RANSAC
(``point_cloud_processing.ego_vel_from_points``), the gates and the carried estimate
(``carry_passing``). The operations launched inside the span itself, read from the stage
readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "points ego-velocity"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("groundvel",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.gnd.vel")
