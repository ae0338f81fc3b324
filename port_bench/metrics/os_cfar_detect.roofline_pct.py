"""Share of its roofline of the compacting OS-CFAR kernel (``csrc/os_cfar_detect.cu``), at the cell's shapes."""

from port_bench.cost.roofline import bound_seconds, os_cfar_detect_compact
from port_bench.lib.readers import roofline_pct

LAYER = "CFAR and compaction"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("bulk",)
KERNEL = r"os_cfar_2d_detect_kernel<true>"


def read(ctx):
    cell = ctx["cell"]
    radar, p = cell.radar, cell.config["processing"]
    bound = bound_seconds(*os_cfar_detect_compact(
        int(cell.mix["batch"]), radar.ns, radar.loops, num_train=p["cfar"]["num_train"],
        num_guard=p["cfar"]["num_guard"], capacity=p["max_dets"]))
    return roofline_pct(ctx, KERNEL, bound)
