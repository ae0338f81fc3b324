"""The host launch path: device operations launched inside the program's spans, per 1024 frames.

Kernels, copies and memsets launched inside any ``mmw.*`` span
(``Stages.call_launches``: each call as the most common call).  A count,
not a timing: it repeats exactly from run to run, and it is the number that
fusing operations or capturing a CUDA graph moves.  Read from the stage
readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stages

LAYER = "host launch path"
UNIT = "launches/kframe"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    s = stages(ctx)
    launches = s.call_launches()
    if launches == 0 or s.frames <= 0:
        return None
    return launches * 1024 / s.frames
