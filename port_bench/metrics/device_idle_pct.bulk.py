"""The device's idle share of the traced window of a bulk cell (layer: device; moves ``frames_per_s``)."""

from port_bench.lib.readers import idle_pct

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("bulk",)


def read(ctx):
    return idle_pct(ctx)
