"""Device time of the matrix-product kernels per 1024 frames: the spectral stages' DFTs (``ops/dft.py``)."""

from port_bench.lib.readers import GEMM, per_kframe_ms

LAYER = "spectral stages"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    seconds, _ = ctx["trace"].kernel_seconds(GEMM.search)
    return per_kframe_ms(seconds, ctx["trace"].frames)
