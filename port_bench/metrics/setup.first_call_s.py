"""Set-up: host seconds of the pipeline's first call, ``mmw.setup.first_call.<kind>``.

The outermost built pipeline's first call that returns, with no fence: its
launches, the kernel loads it makes (``setup.kernel_load_s``), PyTorch's
lazy module loads and the cuBLAS handle.  The traffic's warm-up call.
"""

from port_bench.lib.setup import first_seconds

LAYER = "set-up"
UNIT = "s"
MOVES = "setup_s"
KINDS = ("bulk", "sar", "dbs", "groundvel", "files")


def read(ctx):
    return first_seconds("mmw.setup.first_call.")
