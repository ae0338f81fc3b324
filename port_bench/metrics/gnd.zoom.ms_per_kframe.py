"""The velocity analysis's zoom stage: device ms per 1024 frames of ``mmw.gnd.zoom``.

``parallel/ground_pipeline.py``: the zoom DTFT's factors for every candidate, the DTFT
of the loop-0 chirps and its two strongest peaks. The operations launched inside the
span itself, read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "altimeter zoom"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("groundvel",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.gnd.zoom")
