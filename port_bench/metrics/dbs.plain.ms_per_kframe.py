"""The DBS pipeline's plain stage: device ms per 1024 frames of ``mmw.dbs.plain``.

``parallel/spectral_pipeline.DBSPipeline``: the fallback range-angle map of one chirp
and its resampling to the DBS grid. The operations launched inside the span itself, read
from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "DBS fallback map"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("dbs",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.dbs.plain")
