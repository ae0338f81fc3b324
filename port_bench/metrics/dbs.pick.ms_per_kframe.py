"""The DBS pipeline's pick stage: device ms per 1024 frames of ``mmw.dbs.pick``.

``parallel/spectral_pipeline.DBSPipeline``: the Doppler bins of each frame's velocity,
the gather of the picked values and their magnitude. The operations launched inside the
span itself, read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "DBS velocity-steered pick"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("dbs",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.dbs.pick")
