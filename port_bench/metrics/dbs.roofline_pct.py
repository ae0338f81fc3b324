"""Share of its roofline of the whole DBS call: the bound over the device time under ``mmw.dbs``.

The bound is ``port_bench/cost/dbs.py``'s (the range DFT, the picked points
of the Doppler-angle DFT and the plain map; compute-bound) at the cell's
shapes, per frame of the stage readers' traced window; the time is that of
every device operation launched inside ``mmw.dbs`` or one of its stages
(``port_bench/lib/stages.py``), the gate's select included.
"""

from port_bench.cost.dbs import dbs_call
from port_bench.cost.roofline import bound_seconds
from port_bench.lib.stages import stages

LAYER = "DBS pipeline"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("dbs",)
SPAN = "mmw.dbs"


def read(ctx):
    s = stages(ctx)
    seconds = sum(t for name, t in s.seconds_by_stage().items()
                  if name is not None and (name == SPAN or name.startswith(SPAN + ".")))
    if seconds <= 0 or s.frames <= 0:
        return None
    cell = ctx["cell"]
    p = cell.config["processing"]
    bound = bound_seconds(*dbs_call(s.frames, cell.radar.ns, cell.radar.loops,
                                    len(p["rx_antennas"]), int(p["num_angle_bins"]),
                                    int(p["num_dbs_angle_bins"])))
    return 100.0 * bound / seconds
