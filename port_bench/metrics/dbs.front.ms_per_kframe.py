"""The DBS pipeline's front stage: device ms per 1024 frames of ``mmw.dbs.front``.

``parallel/spectral_pipeline.DBSPipeline``: the planes check, ``torch.complex``, the
channels of the virtual array and the range and Doppler DFTs. The operations launched
inside the span itself, read from the stage readers' traced window
(``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stage_ms_per_kframe

LAYER = "DBS range and Doppler front"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("dbs",)


def read(ctx):
    return stage_ms_per_kframe(ctx, "mmw.dbs.front")
