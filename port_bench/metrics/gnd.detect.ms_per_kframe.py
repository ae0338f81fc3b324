"""The velocity analysis's detect stage: device ms per 1024 frames of ``mmw.gnd.detect``.

``parallel/ground_pipeline.py``: the range DFT of the antenna union, channel 0's Doppler
DFT and magnitude, the altitude row gate, the 1D OS-CFAR by counting and the compaction.
The operations launched inside the span itself, read from the stage readers' traced
window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "ground detector"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("groundvel",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.gnd.detect")
