"""The velocity pipeline's vx readout: device ms per 1024 frames of ``mmw.vel.vx``.

``parallel/velocity_pipeline.py``: the decibel map (``_db``) and the zero-azimuth
readout (``vx_from``).  The operations launched inside the span itself,
read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "velocity vx readout"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.vel.vx")
