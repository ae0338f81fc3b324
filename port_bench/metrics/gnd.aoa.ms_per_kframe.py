"""The velocity analysis's aoa stage: device ms per 1024 frames of ``mmw.gnd.aoa``.

``parallel/ground_pipeline.py``: the shared angle head
(``parallel/point_stages.AngleHead``): the detections' range-Doppler values, the angle
DFTs and the FLU points. The operations launched inside the span itself, read from the
stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "point-cloud angles and points"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("groundvel",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.gnd.aoa")
