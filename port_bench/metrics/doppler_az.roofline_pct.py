"""Share of its roofline of the Doppler-azimuth responses kernel (``csrc/doppler_az_responses.cu``)."""

import math

from port_bench.cost.roofline import bound_seconds, doppler_az_responses
from port_bench.lib.readers import roofline_pct
from port_bench.reference.radar import valid_angle_bins

LAYER = "responses"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("bulk",)
KERNEL = r"doppler_az_responses_kernel"


def read(ctx):
    cell = ctx["cell"]
    radar, v = cell.radar, cell.config["processing"]["velocity"]
    n_angles = valid_angle_bins(v)
    win_rows = min(radar.ns, int(math.ceil(
        (v["lower_range_bound"] + v["upper_range_bound"]) / radar.range_res)) + 2)
    sets = v["az_sets"] + v["el_sets"]
    bound = bound_seconds(*doppler_az_responses(
        int(cell.mix["batch"]), radar.n_virtual, win_rows, radar.loops, n_angles=n_angles,
        n_sets=len(sets), n_rx=len(sets[0])))
    return roofline_pct(ctx, KERNEL, bound)
