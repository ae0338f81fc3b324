"""Set-up: host seconds of the pipeline's build, ``mmw.setup.build.<kind>``.

The outermost ``build_*`` call of the run's traffic (``utils/profiling.timed_builder``):
constants, DFT matrices and buffers made and moved to the device; the
builders it calls in turn record nothing of their own.
"""

from port_bench.lib.setup import first_seconds

LAYER = "set-up"
UNIT = "s"
MOVES = "setup_s"
KINDS = ("bulk", "sar", "dbs", "groundvel", "files")


def read(ctx):
    return first_seconds("mmw.setup.build.")
