"""Stage timing and tracing of the port (JAX: ``utils/profiling.py``).

- :func:`fence` waits for the device work behind the tensors of a tree: on
  CUDA an event recorded on the current stream and synchronised, on the CPU
  nothing (the work is done when the call returns).
- :class:`StageTimer` accumulates wall-clock seconds, calls and items per
  named stage; ``stage(...)`` fences what its ``sink`` was given before it
  stops the clock.  :meth:`StageTimer.record` adds a duration measured
  elsewhere (a loader thread's seconds, CUDA event times).
- :func:`trace` writes a ``torch.profiler`` trace (Chrome / Perfetto JSON);
  :func:`annotate` names a region in it.  The batched pipelines and the
  recording feed name their stages ``mmw.<pipeline>.<stage>``
  (:data:`SPAN_PREFIX`); with no profiler running a span costs one flag check.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils import _pytree

from mmwave_radar_processing_tpu_torch.utils.logger import get_logger

#: the first part of every span the program's stages open
SPAN_PREFIX = "mmw."
_NO_SPAN = contextlib.nullcontext()


def fence(tree) -> None:
    """Wait until the device work that produces every tensor of ``tree`` has completed."""
    devices = {leaf.device for leaf in _pytree.tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()


class StageTimer:
    """Accumulates wall-clock and item counts per named pipeline stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.items: Dict[str, int] = defaultdict(int)

    def record(self, name: str, seconds: float, items: int = 1) -> None:
        """Add one execution of ``name`` that took ``seconds`` over ``items`` items."""
        self.totals[name] += seconds
        self.counts[name] += 1
        self.items[name] += items

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 1, block_on=None):
        """Time one stage execution; pass the stage output via ``sink`` (or
        ``block_on``) to fence asynchronous device work before stopping the clock."""
        t0 = time.perf_counter()
        holder = {}

        def sink(value):
            holder["out"] = value
            return value

        yield sink
        if holder.get("out") is not None:
            fence(holder["out"])
        elif block_on is not None:
            fence(block_on)
        self.record(name, time.perf_counter() - t0, items)

    def report(self) -> str:
        lines = ["stage                     total_s   calls  items   items/s"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            items = self.items[name]
            rate = items / tot if tot > 0 else 0.0
            lines.append(
                f"{name:<24} {tot:8.3f} {self.counts[name]:7d} {items:6d} {rate:9.1f}"
            )
        return "\n".join(lines)

    def log_report(self) -> None:
        get_logger(__name__).info("pipeline timing:\n%s", self.report())

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.items.clear()


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2):
    """``torch.profiler`` over the block (CPU, and CUDA when present); writes ``log_dir/trace.json``.

    ``host_tracer_level`` is accepted for the JAX package's signature and
    ignored: ``torch.profiler`` has no host-tracing levels.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    get_logger(__name__).info("profiler trace written to %s", path)


def annotate(name: str):
    """Named region in the profiler timeline (``torch.profiler.record_function``).

    Without a running profiler it returns one shared ``nullcontext``: no
    call into the dispatcher, so spans on the hot path cost a flag check.
    """
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
