"""Device time per 1024 frames of every kernel that is neither a matrix product nor hand-written.

That is PyTorch's own kernels: RANSAC, the gathers and the elementwise work
(``ops/ransac.py``, ``ops/masked.py``); the peak picker's kernel is hand-written.
"""

from port_bench.lib.readers import GEMM, HAND_WRITTEN, per_kframe_ms

LAYER = "peaks, RANSAC and gathers"
UNIT = "ms/1024frames"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    seconds, _ = ctx["trace"].kernel_seconds(
        lambda name: not GEMM.search(name) and not HAND_WRITTEN.search(name))
    return per_kframe_ms(seconds, ctx["trace"].frames)
