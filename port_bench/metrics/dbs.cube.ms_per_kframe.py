"""The DBS pipeline's cube stage: device ms per 1024 frames of ``mmw.dbs.cube``.

``parallel/spectral_pipeline.DBSPipeline``: the angle DFT that forms the whole ``[B, ns,
loops, M]`` cube. The operations launched inside the span itself, read from the stage
readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "DBS angle cube"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("dbs",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.dbs.cube")
