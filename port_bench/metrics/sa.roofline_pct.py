"""Share of its roofline of the whole synthetic-aperture call: the bound over the device time under ``mmw.sa``.

The bound is ``port_bench/cost/sar.py``'s (the element sum and the range
DFT, compute-bound) at the cell's shapes, per frame of the stage readers'
traced window; the time is that of every device operation launched inside
``mmw.sa`` or one of its stages (``port_bench/lib/stages.py``).
"""

from port_bench.cost.roofline import bound_seconds
from port_bench.cost.sar import depth_call
from port_bench.lib.stages import stages
from port_bench.reference.sar import selected_chirps

LAYER = "synthetic-aperture pipeline"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("sar",)
SPAN = "mmw.sa"


def read(ctx):
    s = stages(ctx)
    seconds = sum(t for name, t in s.seconds_by_stage().items()
                  if name is not None and (name == SPAN or name.startswith(SPAN + ".")))
    if seconds <= 0 or s.frames <= 0:
        return None
    cell = ctx["cell"]
    p = cell.config["processing"]
    chirps = len(selected_chirps(cell.radar, int(p["chirp_cfg_idx"]), int(p["stride"])))
    directions = int(p["az_deg"][2]) * int(p["el_deg"][2])
    bound = bound_seconds(*depth_call(s.frames, cell.radar.ns, chirps, int(p["num_frames"]),
                                      directions))
    return 100.0 * bound / seconds
