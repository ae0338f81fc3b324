"""The synthetic-aperture window: device ms per 1024 frames of ``mmw.sa.window``.

``parallel/beamform_pipeline.py``: the selection of the receiver and chirps, the carried
ring, the unfold and the element window.  The operations launched inside the span
itself, read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "synthetic-aperture window"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("sar",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.sa.window")
