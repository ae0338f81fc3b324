"""The program's stage spans (``mmw.*``) and the device operations launched inside each.

The harness's trace (:mod:`port_bench.lib.trace`) keeps the benchmark's own
``pb.*`` spans and drops the program's, with the launch records that tie a
device operation to the host thread and the time it was launched.  So the
stage readers trace a window of their own, after the run's: the same
cell's traffic (its traffic kind's ``Run``), made from ``REPLAY_SEED``, for
``REPLAY_SECONDS`` (or the run's traced seconds, if fewer): every batch
repeats the same stages, so a second of batches gives each stage's share,
and the traced run stays short.  :class:`StageTracer` keeps, of that
window's Chrome trace:

- the ``user_annotation`` events named ``mmw.*``, by host thread;
- the runtime and driver calls that carry a ``correlation`` (kernel
  launches, ``cudaMemcpyAsync``, ``cudaMemsetAsync``), by that number;
- every device operation with its ``correlation``.

A device operation belongs to the innermost ``mmw.*`` span open on the
launching thread when it was launched (:meth:`Stages.stage_of`), and to
the call of the outermost one; a nested span takes its own operations.
Operations launched outside every such span (the harness's own: its copies
to the host, and in the combined cell its stack of the fit fields) belong
to none.  A program without the spans yields no stage, and every stage
reader returns None.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from port_bench.lib.harness import Context, Window
from port_bench.lib.readers import per_kframe_ms
from port_bench.lib.trace import DEVICE_CATS, Tracer

#: the first part of the program's stage spans (``utils/profiling.SPAN_PREFIX``)
PROGRAM_PREFIX = "mmw."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the replayed window's inputs and draws; the run's own seed is not handed to readers
REPLAY_SEED = 0
REPLAY_SECONDS = 1.0

Span = Tuple[str, float, float]


def enclosing(spans: List[Span], points: List[Tuple[float, int]]
              ) -> Dict[int, Optional[Tuple[Span, Span]]]:
    """For each ``(time, key)`` of ``points``: the innermost and the outermost of ``spans`` open then.

    ``spans`` are ``(name, start, end)`` of one thread, so they nest or are
    disjoint; one sweep over both in time order with a stack of open spans.
    None where no span is open.
    """
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    found: Dict[int, Optional[Tuple[Span, Span]]] = {}
    stack: List[Span] = []
    i = 0
    for t, key in sorted(points):
        while i < len(order) and order[i][1] <= t:
            while stack and stack[-1][2] <= order[i][1]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        found[key] = (stack[-1], stack[0]) if stack else None
    return found


@dataclass
class Stages:
    """Device operations of a traced window, each with the program's stage that launched it."""

    frames: int
    device_ops: List[Tuple[str, float, float, Optional[int]]] = field(default_factory=list)
    spans: Dict[int, List[Span]] = field(default_factory=dict)
    #: by correlation: the innermost span's name, and the call (thread, outermost span)
    stage_by_correlation: Dict[int, str] = field(default_factory=dict)
    call_by_correlation: Dict[int, Tuple[int, Span]] = field(default_factory=dict)

    @classmethod
    def from_events(cls, events: List[dict], frames: int) -> "Stages":
        """Reduce a Chrome trace's ``traceEvents``: spans by thread, launches and device operations."""
        out = cls(frames)
        spans: Dict[int, list] = defaultdict(list)
        launches: Dict[int, list] = defaultdict(list)  # by thread: (time, correlation)
        for e in events:
            cat, ts, dur = e.get("cat"), e.get("ts"), e.get("dur")
            if ts is None or dur is None:
                continue
            name, ts, dur = e.get("name", ""), float(ts), float(dur)
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                out.device_ops.append((name, ts, dur, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[e.get("tid")].append((ts, corr))
            elif cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
                spans[e.get("tid")].append((name, ts, ts + dur))
        out.spans = dict(spans)
        for tid, points in launches.items():
            for corr, found in enclosing(out.spans.get(tid, []), points).items():
                if found is not None:
                    out.stage_by_correlation[corr] = found[0][0]
                    out.call_by_correlation[corr] = (tid, found[1])
        return out

    def stage_of(self, op: Tuple[str, float, float, Optional[int]]) -> Optional[str]:
        """The innermost ``mmw.*`` span open on the launching thread at ``op``'s launch, or None."""
        return self.stage_by_correlation.get(op[3])

    def seconds_by_stage(self) -> Dict[Optional[str], float]:
        """Device seconds of the operations of each stage; None holds those of no stage."""
        seconds: Dict[Optional[str], float] = defaultdict(float)
        for op in self.device_ops:
            seconds[self.stage_of(op)] += op[2] / 1e6
        return dict(seconds)

    def stage_seconds(self, name: str) -> float:
        """Device seconds of the operations attributed to span ``name`` itself."""
        return self.seconds_by_stage().get(name, 0.0)

    def call_launches(self) -> int:
        """Device operations launched inside the program's calls (outermost ``mmw.*`` spans).

        Each call counts as many as the most common call of its kind: the
        batched pipelines launch the same operations at every call, and the
        most common count does not move when the profiler loses an event,
        as it can in the first call it traces.
        """
        per_call = Counter(self.call_by_correlation[op[3]] for op in self.device_ops
                           if op[3] in self.call_by_correlation)
        by_kind: Dict[str, Counter] = defaultdict(Counter)
        for (_, (name, _, _)), n in per_call.items():
            by_kind[name][n] += 1
        return sum(counts.most_common(1)[0][0] * sum(counts.values())
                   for counts in by_kind.values())


class StageTracer(Tracer):
    """The harness's tracer, reduced to :class:`Stages` in place of the harness's ``Trace``."""

    def stop(self, window_s: float, frames: int) -> None:
        self._mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
        self.prof = None
        self.trace = Stages.from_events(events, frames)


def replay(cell, seconds: float, seed: int = REPLAY_SEED) -> Stages:
    """Run ``cell``'s traffic again for ``seconds``, traced by :class:`StageTracer`."""
    device = (torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
              else torch.device("cpu"))
    run = cell.traffic_module().Run(Context(cell, seed, device))
    tracer = StageTracer(seconds)
    try:
        run.window(Window(seconds, device, tracer))
    finally:
        run.release()
    return tracer.trace


def stages(ctx) -> Stages:
    """The stage trace of the run's cell, replayed once a run."""
    if "stages" not in ctx:
        ctx["stages"] = replay(ctx["cell"], min(REPLAY_SECONDS, ctx["trace"].window_s))
    return ctx["stages"]


def stage_ms_per_kframe(ctx, name: str) -> Optional[float]:
    """Device ms per 1024 frames of span ``name``'s own operations; None where it launched none."""
    s = stages(ctx)
    return per_kframe_ms(s.stage_seconds(name), s.frames)
