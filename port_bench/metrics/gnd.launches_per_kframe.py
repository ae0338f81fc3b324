"""The velocity analysis's launches: device operations inside ``mmw.gnd`` per 1024 frames.

Kernels, copies and memsets launched inside the span of a call
(``Stages.call_launches``: each call as the most common call), read from
the stage readers' traced window (``port_bench/lib/stages.py``).
"""

from port_bench.lib.stages import stages

LAYER = "host launch path"
UNIT = "launches/kframe"
MOVES = "frames_per_s"
KINDS = ("groundvel",)


def read(ctx):
    s = stages(ctx)
    launches = s.call_launches()
    if launches == 0 or s.frames <= 0:
        return None
    return launches * 1024 / s.frames
