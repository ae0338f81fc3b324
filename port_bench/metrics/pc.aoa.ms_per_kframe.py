"""The point-cloud angles and points: device ms per 1024 frames of ``mmw.pc.aoa``.

``parallel/pipeline.py``: the detected cells' values (``rd_values``), both angle DFTs
and their argmax, and the cartesian points.  The operations launched inside the span itself,
read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "point-cloud angles and points"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.pc.aoa")
