"""The point-cloud range/Doppler front: device ms per 1024 frames of ``mmw.pc.spectral``.

``parallel/pipeline.py``: ``torch.complex`` of the planes, the range DFT, the Doppler
DFT of channel 0 and its magnitude.  The operations launched inside the span itself,
read from the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "point-cloud range/Doppler front"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.pc.spectral")
