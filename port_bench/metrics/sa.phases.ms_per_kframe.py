"""The synthetic-aperture steering phases: device ms per 1024 frames of ``mmw.sa.phases``.

``parallel/beamform_pipeline.py``: the steering phases ``exp(j 2 pi (d . p) / lambda)``
of every frame's aperture, ``[T, A, E]``.  The operations launched inside the span
itself, read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "steering phases"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("sar",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.sa.phases")
