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
- :data:`SETUP` holds the process's set-up (``mmw.setup.<name>``,
  :func:`setup_span`: host seconds, no fence, under a span of that name):
  ``cuda_init`` (:func:`start_cuda`), ``build.<kind>`` and
  ``first_call.<kind>`` of each pipeline an outermost :func:`timed_builder`
  builds, ``kernel.<source>`` and ``nvcc.<source>`` (``ops/kernels/_build.py``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
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
    """Accumulates wall-clock and item counts per named pipeline stage, and each stage's first seconds."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.items: Dict[str, int] = defaultdict(int)
        self.first: Dict[str, float] = {}

    def record(self, name: str, seconds: float, items: int = 1) -> None:
        """Add one execution of ``name`` that took ``seconds`` over ``items`` items."""
        self.totals[name] += seconds
        self.counts[name] += 1
        self.items[name] += items
        self.first.setdefault(name, seconds)

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
        width = max([24, *map(len, self.totals)])
        lines = [f"{'stage':<{width}}  total_s   calls  items   items/s  first_s"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            items = self.items[name]
            rate = items / tot if tot > 0 else 0.0
            lines.append(f"{name:<{width}} {tot:8.3f} {self.counts[name]:7d} {items:6d} "
                         f"{rate:9.1f} {self.first[name]:8.3f}")
        return "\n".join(lines)

    def log_report(self, title: str = "pipeline timing") -> None:
        get_logger(__name__).info("%s:\n%s", title, self.report())

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.items.clear()
        self.first.clear()


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


#: the process's set-up, by ``mmw.setup.<name>``; a name's first record is its first start
SETUP = StageTimer()
SETUP_PREFIX = SPAN_PREFIX + "setup."
_building = threading.local()  # .open: a timed builder is open on this thread


@contextlib.contextmanager
def setup_span(name: str):
    """Time a block of set-up into :data:`SETUP` as ``mmw.setup.<name>``: host seconds, no fence.

    The block runs under :func:`annotate` of the same name, so under
    :func:`trace` it lies on one clock with the device work after it.
    """
    full = SETUP_PREFIX + name
    t0 = time.perf_counter()
    with annotate(full):
        yield
    SETUP.record(full, time.perf_counter() - t0)


def start_cuda(device) -> None:
    """Start CUDA for ``device`` inside ``mmw.setup.cuda_init`` if nothing has started it yet.

    It is the work the first tensor on the device would do anyway: the
    context and the allocator's first block.  Not a CUDA device, or one
    already started: nothing.
    """
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available() and not torch.cuda.is_initialized():
        with setup_span("cuda_init"):
            torch.empty(1, device=device)


def time_first_call(pipeline, kind: str):
    """Record ``pipeline``'s first call that returns as ``mmw.setup.first_call.<kind>``; returns it.

    A forward pre-hook starts the clock and the span, a forward hook stops
    them and removes both hooks: later calls find no hook, as before.
    Host seconds with no fence: the call's launches, and the kernel loads,
    lazy module loads and library handles it starts.
    """
    name = SETUP_PREFIX + "first_call." + kind
    call = {}

    def start(module, args):
        if "span" in call:  # a first call that raised left its span open
            call.pop("span").__exit__(None, None, None)
        call["span"] = annotate(name)
        call["span"].__enter__()
        call["t0"] = time.perf_counter()

    def stop(module, args, output):
        SETUP.record(name, time.perf_counter() - call["t0"])
        call.pop("span").__exit__(None, None, None)
        pre.remove()
        post.remove()

    pre = pipeline.register_forward_pre_hook(start)
    post = pipeline.register_forward_hook(stop)
    return pipeline


def timed_builder(kind: str):
    """Decorate a pipeline builder: its set-up goes to :data:`SETUP` when no other builder is open.

    The outermost call starts CUDA (:func:`start_cuda` on its ``device``),
    records ``mmw.setup.build.<kind>`` and times its pipeline's first call
    (:func:`time_first_call`); builders it calls in turn record nothing.
    """
    def decorate(builder):
        @functools.wraps(builder)
        def build(*args, **kwargs):
            if getattr(_building, "open", False):
                return builder(*args, **kwargs)
            if "device" in kwargs:
                start_cuda(kwargs["device"])
            _building.open = True
            try:
                with setup_span("build." + kind):
                    pipeline = builder(*args, **kwargs)
            finally:
                _building.open = False
            return time_first_call(pipeline, kind)
        return build
    return decorate
