"""Share of its roofline of the velocity peak picker (``csrc/prominent_peak.cu``), at the cell's shapes.

Its rows are the dB maps of the azimuth and elevation fits: per frame two
maps of one row a Doppler bin, each row the valid angle bins.
"""

from port_bench.cost.roofline import bound_seconds, prominent_peak
from port_bench.lib.readers import roofline_pct
from port_bench.reference.radar import valid_angle_bins

LAYER = "velocity peak picker"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("bulk",)
KERNEL = r"prominent_peak_kernel"


def read(ctx):
    cell = ctx["cell"]
    rows = int(cell.mix["batch"]) * 2 * cell.radar.loops
    n = valid_angle_bins(cell.config["processing"]["velocity"])
    return roofline_pct(ctx, KERNEL, bound_seconds(*prominent_peak(rows, n)))
