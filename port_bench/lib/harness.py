"""One run of one cell: find its pieces by name, set up, measure, check, and make the result line.

The pieces, each a file of its own under the benchmark's folder:

- ``workloads/<cell>.json``: the cell's configuration and traffic mix, the
  frames the check samples, the traced seconds and the check's limits;
- ``configs/<config>.json``: one deployment (its ``.cfg`` lines, geometry,
  processing parameters and precision);
- ``traffic/mixes/<mix>.json``: a traffic mix, whose ``kind`` names the
  module ``traffic/<kind>.py`` that drives it;
- ``metrics/<metric>.py``: one per-layer metric, a reader of the trace.

A traffic kind's module has a class ``Run(ctx)`` whose constructor is the
set-up, ``window(window)`` the measured loop (it returns the end-to-end
values it measured), ``release()`` frees the program's state and
``check()`` returns the numbers that decide ``correct``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from port_bench.lib.trace import Tracer
from port_bench.reference.radar import Radar, parse_cfg

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules the process must not hold once the window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mmwave_radar_processing_tpu")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """A cell's files, read by name from the benchmark's folder ``root``."""

    name: str
    spec: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    radar: Radar

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Cell":
        spec = load_json(root / "workloads" / f"{name}.json")
        config = load_json(root / "configs" / f"{spec['config']}.json")
        mix = load_json(root / "traffic" / "mixes" / f"{spec['traffic']}.json")
        return cls(name, spec, config, mix, parse_cfg(config["cfg_lines"]))

    def traffic_module(self, root: Path = ROOT):
        kind = self.mix["kind"]
        return load_module(root / "traffic" / f"{kind}.py", f"port_bench_traffic_{kind}")


def metric_modules(root: Path = ROOT) -> Dict[str, Any]:
    """Every per-layer metric's reader, by the metric's name (its file name)."""
    return {p.name[:-3]: load_module(p, "port_bench_metric_" + p.name[:-3].replace(".", "_"))
            for p in sorted((root / "metrics").glob("*.py"))}


@dataclass
class Context:
    """What a traffic kind is handed: the cell, the run's seed and device, a planted fault or the control."""

    cell: Cell
    seed: int
    device: torch.device
    fault: Optional[str] = None
    control: bool = False

    def program(self, pipeline, kind: str):
        """What the timed path calls: the program's pipeline, or a fault planted in it, or the control."""
        if self.control:
            from port_bench.lib.control import ReferencePipeline

            return ReferencePipeline(self.cell, kind)
        if self.fault:
            from port_bench.lib import faults

            return faults.wrap(pipeline, self.fault, self.cell.radar.vel_res)
        return pipeline

    def port_config(self):
        """The deployment as the program parses it, from the configuration's own ``.cfg`` lines."""
        from mmwave_radar_processing_tpu_torch.config import load_cfg

        fd, path = tempfile.mkstemp(suffix=".cfg")
        try:
            with os.fdopen(fd, "w") as f:
                f.write("\n".join(self.cell.config["cfg_lines"]) + "\n")
            return load_cfg(path, array_geometry=self.cell.config["array_geometry"],
                            array_direction=self.cell.config["array_direction"])
        finally:
            os.remove(path)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The measured window: host clock, frames completed, and the traced part at its start."""

    def __init__(self, seconds: float, device: torch.device, tracer: Optional[Tracer] = None):
        self.seconds, self.device, self.tracer = seconds, device, tracer
        self.frames = 0
        self.t0 = self.wall = None

    def start(self) -> None:
        synchronize(self.device)
        if self.tracer:
            self.tracer.start()
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def done(self, frames: int) -> bool:
        """Count ``frames`` as submitted; True once the window's time is up."""
        self.frames += frames
        if self.tracer and self.tracer.trace is None and self.tracer.prof is not None \
                and self.elapsed() >= self.tracer.seconds:
            synchronize(self.device)
            self.tracer.stop(self.elapsed(), self.frames)
        return self.elapsed() >= self.seconds

    def finish(self) -> float:
        synchronize(self.device)
        self.wall = self.elapsed()
        if self.tracer and self.tracer.trace is None:
            self.tracer.stop(self.wall, self.frames)
        return self.wall


def device_info(device: torch.device, chips: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def run_cell(name: str, *, seed: int, seconds: float, trace: bool, device, t_start: float,
             fault: Optional[str] = None, control: bool = False,
             root: Path = ROOT) -> Dict[str, Any]:
    """One run of cell ``name``: the result line's fields, ``checks`` last."""
    device = torch.device(device)
    cell = Cell.load(name, root)
    run = cell.traffic_module(root).Run(Context(cell, seed, device, fault, control))
    try:
        return _measure(run, cell, seconds=seconds, trace=trace, device=device,
                        t_start=t_start, root=root)
    finally:
        if hasattr(run, "close"):
            run.close()


def _measure(run, cell: Cell, *, seconds, trace, device, t_start, root) -> Dict[str, Any]:
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(float(cell.spec.get("trace_seconds", seconds))) if trace else None
    window = Window(seconds, device, tracer)
    values = run.window(window)
    attempted, failed = values.pop("attempted"), values.pop("failed")
    dev = device_info(device, int(cell.spec.get("chips", 1)))
    breakdown = None
    if trace:
        t = tracer.trace
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        ctx = {"cell": cell, "trace": t, "values": values}
        metrics = {}
        for metric, module in metric_modules(root).items():
            value = module.read(ctx) if cell.mix["kind"] in module.KINDS else None
            if value is not None:
                metrics[metric] = {"value": value, "unit": module.UNIT}
        breakdown = t.breakdown()
    else:
        metrics = {k: {"value": v, "unit": run.UNITS[k]} for k, v in values.items()
                   if k in run.UNITS}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    run.release()
    checks = run.check()
    result: Dict[str, Any] = {"correct": all(c.ok for c in checks), "attempted": attempted,
                              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result
