"""Share of its roofline of the whole velocity-analysis call: the bound over the device time under ``mmw.gnd``.

The bound is ``port_bench/cost/ground.py``'s (the altimeter's coarse and zoom
transforms, the range and Doppler transforms, each at the lesser of a direct
sum and an FFT, the gated CFAR, the angles of the detections, the RANSAC
trials and the planes read once; byte-bound) at the cell's shapes, with
the traced run's mean detections and gated rows a frame, per frame of the
stage readers' traced window; the time is that of every device operation
launched inside ``mmw.gnd`` or one of its stages (``port_bench/lib/stages.py``).
"""

from port_bench.cost.ground import ground_call
from port_bench.cost.roofline import bound_seconds
from port_bench.lib.stages import stages
from port_bench.reference.ground import settings

LAYER = "velocity analysis pipeline"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("groundvel",)
SPAN = "mmw.gnd"


def read(ctx):
    values = ctx["values"]
    if "dets_per_frame" not in values:
        return None
    s = stages(ctx)
    seconds = sum(t for name, t in s.seconds_by_stage().items()
                  if name is not None and (name == SPAN or name.startswith(SPAN + ".")))
    if seconds <= 0 or s.frames <= 0:
        return None
    cell = ctx["cell"]
    p, r = settings(cell.config["processing"]), cell.radar
    union = len(set(p["az_antennas"]) | set(p["el_antennas"]) | {0})
    dims = 2 if cell.config["array_geometry"] == "standard" else 3
    bound = bound_seconds(*ground_call(
        s.frames, ns=r.ns, loops=r.loops, rx=r.num_rx, cpl=r.cpl, union=union,
        az_antennas=len(p["az_antennas"]), el_antennas=len(p["el_antennas"]),
        angle_bins=p["num_angle_bins"], capacity=p["max_dets"],
        num_train=int(p["vel_cfar"]["num_train"]), num_guard=int(p["vel_cfar"]["num_guard"]),
        trials=p["ransac_max_trials"], samples=p["ransac_min_samples"], dims=dims,
        dets_per_frame=values["dets_per_frame"],
        gated_rows_per_frame=values["gated_rows_per_frame"]))
    return 100.0 * bound / seconds
