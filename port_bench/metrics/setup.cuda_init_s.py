"""Set-up: host seconds of the CUDA context's start inside the program, ``mmw.setup.cuda_init``.

A builder that finds CUDA not yet started on its device starts it there
(``utils/profiling.start_cuda``).  The ``sar``, ``dbs`` and ``groundvel``
traffic kinds build before they make their flight, so the start lies in
the program; the ``bulk`` kind makes its frames first, and reads None.
"""

from port_bench.lib.setup import first_seconds

LAYER = "set-up"
UNIT = "s"
MOVES = "setup_s"
KINDS = ("bulk", "sar", "dbs", "groundvel", "files")


def read(ctx):
    return first_seconds("mmw.setup.cuda_init")
