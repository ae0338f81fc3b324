"""The velocity analysis's track stage: device ms per 1024 frames of ``mmw.gnd.track``.

``parallel/ground_pipeline.py``: the tracker's start and the recursion
(``ops/altitude.altitude_track``: on the card ``csrc/altitude_track.cu``, one launch a
call). The operations launched inside the span itself, read from the stage readers'
traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "altitude recursion"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("groundvel",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.gnd.track")
