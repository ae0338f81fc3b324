"""The velocity analysis's range stage: device ms per 1024 frames of ``mmw.gnd.range``.

``parallel/ground_pipeline.py``: the planes check, ``torch.complex``, the loop-0 chirp
of every virtual channel, the coarse range DFT, the mean magnitude in dB and the three
strongest prominent peaks. The operations launched inside the span itself, read from the
stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "ground range front"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("groundvel",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.gnd.range")
