"""The velocity pipeline's window and DFTs: device ms per 1024 frames of ``mmw.vel.window_dft``.

``parallel/velocity_pipeline.py``: the altitude window, the windowed range DFT and the
chirp DFT.  The operations launched inside the span itself,
read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "velocity window and DFTs"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.vel.window_dft")
