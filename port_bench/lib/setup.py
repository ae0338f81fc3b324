"""The program's set-up records (``mmw.setup.*``), read by the ``setup.*`` metrics.

The port keeps them in ``mmwave_radar_processing_tpu_torch.utils.profiling.SETUP``,
a ``StageTimer`` of the process, with each name's first duration in
``first``: the run's own start.  A second build of the same pipeline in the
process (the stage readers' replay, ``lib/stages.py``) adds calls, never a
first.  A program without the records, or a run that left none of a
metric's names (the control builds no pipeline), yields None.
"""

from __future__ import annotations

from typing import Optional


def first_seconds(prefix: str) -> Optional[float]:
    """The sum of the first records of every ``SETUP`` name that starts with ``prefix``, or None."""
    try:
        from mmwave_radar_processing_tpu_torch.utils import profiling
    except ImportError:
        return None
    first = getattr(getattr(profiling, "SETUP", None), "first", None)
    if not isinstance(first, dict):
        return None
    hits = [seconds for name, seconds in first.items() if name.startswith(prefix)]
    return float(sum(hits)) if hits else None
