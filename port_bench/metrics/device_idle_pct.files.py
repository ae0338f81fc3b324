"""The device's idle share of the traced window of a files cell (layer: device; moves ``file_frames_per_s``)."""

from port_bench.lib.readers import idle_pct

LAYER = "device"
UNIT = "%"
MOVES = "file_frames_per_s"
KINDS = ("files",)


def read(ctx):
    return idle_pct(ctx)
