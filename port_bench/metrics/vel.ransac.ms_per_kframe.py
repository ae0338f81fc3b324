"""RANSAC fits and gates: device ms per 1024 frames of ``mmw.vel.ransac``.

The two ``vy`` fits of ``ops/ransac.py`` through ``VelocityPipeline.fit_vy``, the R^2
and inlier gates and the output stack.  The operations launched inside the span itself,
read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "RANSAC fits and gates"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.vel.ransac")
