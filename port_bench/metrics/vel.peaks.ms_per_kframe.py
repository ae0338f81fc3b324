"""The velocity peak picker: device ms per 1024 frames of ``mmw.vel.peaks``.

Each velocity row's highest prominent angle peak: ``ops/peaks.best_prominent_peak``
through ``VelocityPipeline.row_peaks``.  The operations launched inside the span itself,
read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "velocity peak picker"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.vel.peaks")
