"""The synthetic-aperture range DFT: device ms per 1024 frames of ``mmw.sa.range_dft``.

``parallel/beamform_pipeline.py``: the windowed range DFT and the magnitude.  The
operations launched inside the span itself, read from the stage readers' traced window
(``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "synthetic-aperture range DFT"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("sar",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.sa.range_dft")
