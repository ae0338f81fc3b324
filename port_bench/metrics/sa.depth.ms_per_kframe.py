"""The synthetic-aperture depth head: device ms per 1024 frames of ``mmw.sa.depth``.

``parallel/beamform_pipeline.py``: each direction's strongest range bin and its floor
against the frame's peak.  The operations launched inside the span itself, read from the
stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "depth head"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("sar",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.sa.depth")
