"""Set-up: host seconds of loading the hand-written CUDA libraries, ``mmw.setup.kernel.<source>``.

``ops/kernels/_build.load``, once a process for each source: the hash of
the source, any ``nvcc`` build (``mmw.setup.nvcc.<source>``, nested) and the
``ctypes`` load.  The loads happen inside the first call, so they lie
inside ``setup.first_call_s`` too.
"""

from port_bench.lib.setup import first_seconds

LAYER = "set-up"
UNIT = "s"
MOVES = "setup_s"
KINDS = ("bulk", "sar", "dbs", "groundvel", "files")


def read(ctx):
    return first_seconds("mmw.setup.kernel.")
