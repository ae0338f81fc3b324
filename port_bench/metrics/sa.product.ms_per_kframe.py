"""The synthetic-aperture element sum: device ms per 1024 frames of ``mmw.sa.product``.

``parallel/beamform_pipeline.py``: the element sum, one batched complex GEMM ``[T, ns,
E] @ [T, E, A]``.  The operations launched inside the span itself, read from the stage
readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "synthetic-aperture product"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("sar",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.sa.product")
