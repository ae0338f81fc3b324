"""The traced window: ``torch.profiler`` over CPU and CUDA, reduced to what the per-layer readers need.

The profiler's Chrome trace is written to a temporary file, read back and
deleted.  Device operations are its ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; the host's activity is the benchmark's own spans
(``pb.*``, :func:`span`) and the operators under them.  Both lie on one
clock in the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "pb."
#: namespaces and keywords that every PyTorch kernel's name repeats, dropped in the breakdown
NAME_NOISE = ("void ", "at::native::", "(anonymous namespace)::", "at::cuda::detail::", "std::")


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without the namespaces every PyTorch kernel repeats, cut to ``width``."""
    for noise in NAME_NOISE:
        name = name.replace(noise, "")
    return name[:width]


def span(name: str):
    """A named host span of the benchmark's own (``pb.<name>``) around a call into a layer."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def union_seconds(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """``(length, merged intervals)`` of the union of ``[start, end]`` intervals in microseconds."""
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged) / 1e6, [(s, e) for s, e in merged]


@dataclass
class Trace:
    """What a traced window left: device operations, host spans and the window's extent."""

    window_s: float
    frames: int
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # name, ts, dur (us)
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)  # all device events
    spans: List[Tuple[str, float, float]] = field(default_factory=list)  # pb.* host spans
    start_us: float = 0.0
    end_us: float = 0.0

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device, within the window."""
        clipped = [(max(ts, self.start_us), min(ts + dur, self.end_us))
                   for _, ts, dur in self.device_ops]
        return union_seconds([(s, e) for s, e in clipped if e > s])[0]

    def kernel_seconds(self, match) -> Tuple[float, int]:
        """``(seconds, calls)`` of the kernels whose name ``match`` accepts."""
        hits = [dur for name, _, dur in self.kernels if match(name)]
        return sum(hits) / 1e6, len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time and the idle time by the host's span."""
        by_op: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.device_ops:
            by_op[short_name(name)] += dur / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        _, busy = union_seconds([(ts, ts + dur) for _, ts, dur in self.device_ops])
        gaps, cursor = [], self.start_us
        for start, end in busy:
            if start > cursor:
                gaps.append((cursor, min(start, self.end_us)))
            cursor = max(cursor, end)
        if cursor < self.end_us:
            gaps.append((cursor, self.end_us))
        idle: Dict[str, float] = defaultdict(float)
        for start, end in gaps:
            if end > start:
                idle[self.host_activity(start)] += (end - start) / 1e6
        gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gap_list]}

    def host_activity(self, t_us: float) -> str:
        """The innermost ``pb.*`` span open at ``t_us``, or ``host`` where none is."""
        best, best_len = "host", float("inf")
        for name, ts, dur in self.spans:
            if ts <= t_us < ts + dur and dur < best_len:
                best, best_len = name, dur
        return best


class Tracer:
    """Profiles the first ``seconds`` of a window; the window ends the trace with a synchronize."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof: Optional[torch.profiler.profile] = None
        self.trace: Optional[Trace] = None
        self._mark = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._mark = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._mark.__enter__()

    def stop(self, window_s: float, frames: int) -> None:
        """End the trace (the device already drained) and reduce it."""
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
        trace = Trace(window_s=window_s, frames=frames)
        for e in events:
            cat, ts, dur = e.get("cat"), e.get("ts"), e.get("dur")
            if ts is None or dur is None:
                continue
            item = (e.get("name", ""), float(ts), float(dur))
            if cat in DEVICE_CATS:
                trace.device_ops.append(item)
                if cat == "kernel":
                    trace.kernels.append(item)
            elif cat == "user_annotation" and item[0].startswith(SPAN_PREFIX):
                trace.spans.append(item)
        window = [s for s in trace.spans if s[0] == SPAN_PREFIX + "window"]
        if window:
            trace.start_us = window[0][1]
            trace.end_us = window[0][1] + window[0][2]
            trace.window_s = window[0][2] / 1e6
        self.trace = trace
