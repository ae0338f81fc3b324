"""The recording feed's share of the wall time spent waiting for the loader (``parallel/recording.py``).

The program's own ``StageTimer`` spans, summed over every pass of the window:
``load_wait`` over ``wall``.
"""

LAYER = "recording feed"
UNIT = "%"
MOVES = "file_frames_per_s"
KINDS = ("files",)


def read(ctx):
    v = ctx["values"]
    if v.get("wall_s", 0.0) <= 0:
        return None
    return 100.0 * v["load_wait_s"] / v["wall_s"]
