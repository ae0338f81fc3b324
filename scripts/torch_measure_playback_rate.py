#!/usr/bin/env python
"""Measure the viewer's playback rate with four live cells, with the PyTorch port (twin of ``measure_playback_rate.py``).

The controller's fan-out runs on ``--device`` (default cuda; the CPU only
when asked for); the cells draw on the host:

- ``--backend matplotlib`` (default, headless): ``ShellLogic`` and the
  matplotlib views on Agg canvases, a full canvas draw a cell a frame (what
  playback and export do);
- ``--backend pyqtgraph``: the real-time tier (ImageItem, OpenGL cloud) in
  the real window, pumped by its event loop; needs pyqtgraph and Qt.

Usage (from the repository root):
    python scripts/torch_measure_playback_rate.py [--frames 60] [--backend matplotlib]

Prints one JSON line: ``backend``, ``device`` (and ``card`` on CUDA),
``frames``, ``fps``, ``ms_per_tick``, ``cells``, and for matplotlib the
processing-only rate and the drawing's share of a tick.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CFG_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                        "6843_RadVel_ods_20Hz.cfg")
KEYS = ["range_doppler_resp", "range_resp", "micro_doppler_resp",
        "doppler_azimuth_resp"]


def build_controller(root: str, n_frames: int, device):
    """A controller on ``device`` over a simulated ``n_frames`` recording with odometry, written under ``root``."""
    from mmwave_radar_processing_tpu_torch.config import load_cfg
    from mmwave_radar_processing_tpu_torch.data import (
        PointTarget, Scene, make_odom_rows, simulate_frame, write_dataset,
    )
    from mmwave_radar_processing_tpu_torch.visualization import (
        MmWaveRadarProcessorController,
        get_default_registry,
    )

    rng = np.random.default_rng(0)
    cfg = load_cfg(CFG_PATH, "ods", "down")
    frames, odom = [], []
    for i in range(n_frames):
        scene = Scene(targets=[
            PointTarget(range_m=1.0 + 0.3 * (i % 3), azimuth_rad=0.2,
                        velocity_m_s=0.4, rcs=4.0)], noise_sigma=0.04)
        frames.append(simulate_frame(cfg, scene, rng))
        odom.append(make_odom_rows(np.array([0.2, 0.0, 0.0])))
    write_dataset(os.path.join(root, "rec"), np.stack(frames), odom=np.stack(odom))

    ctl = MmWaveRadarProcessorController(registry=get_default_registry(), device=device)
    ctl.load_dataset(os.path.join(root, "rec"))
    ctl.load_config(CFG_PATH, "ods", "down")
    ctl.init_processors()
    return ctl, CFG_PATH


def measure_matplotlib(ctl, n_frames: int):
    """``(fps with draws, fps processing only)``: the drawing tier apart."""
    import matplotlib.pyplot as plt

    from mmwave_radar_processing_tpu_torch.visualization.shell_logic import ShellLogic

    logic = ShellLogic(ctl, num_cells=4, initial_keys=list(KEYS))
    figs = []
    for cell, key in enumerate(KEYS):
        fig, ax = plt.subplots(figsize=(5, 4))
        figs.append(fig)
        logic.bind_cell_view(cell, logic.view_class_for(key)(ax=ax))

    def run(with_draws: bool) -> float:
        logic.set_render_callback(
            (lambda cell: figs[cell].canvas.draw()) if with_draws
            else (lambda cell: None))
        ctl.process_next_frame(0)  # warm-up: the first calls
        t0 = time.perf_counter()
        for i in range(n_frames):
            ctl.process_next_frame(i % ctl.dataset_model.num_frames)
        return n_frames / (time.perf_counter() - t0)

    return run(True), run(False)


def measure_pyqtgraph(ctl, n_frames: int) -> float:
    from PyQt6 import QtWidgets

    from mmwave_radar_processing_tpu_torch.visualization.qt_shell import build_main_window

    app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
    win = build_main_window(ctl, view_keys=list(KEYS), backend="pyqtgraph")
    win.show()
    app.processEvents()
    ctl.process_next_frame(0)
    t0 = time.perf_counter()
    for i in range(n_frames):
        ctl.process_next_frame(i % ctl.dataset_model.num_frames)
        app.processEvents()
    dt = time.perf_counter() - t0
    win.close()
    return n_frames / dt


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--build-frames", type=int, default=8,
                    help="the recording's frames; the precompute's build cost is spread "
                         "over them, so measure it at a realistic length (e.g. 64)")
    ap.add_argument("--backend", choices=["matplotlib", "pyqtgraph"], default="matplotlib")
    ap.add_argument("--precompute", action="store_true",
                    help="precompute-then-scrub: build the playback cache on the device "
                         "first (controller.enable_precomputed_playback), then serve the "
                         "ticks from it")
    ap.add_argument("--only-selected", action="store_true",
                    help="keep only the four displayed processors instead of the whole "
                         "registry's fan-out")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fan-out (default cuda; cpu only when asked for)")
    args = ap.parse_args()

    if args.backend == "matplotlib":
        import matplotlib

        matplotlib.use("Agg")

    fps_proc = None
    build_s = covered = None
    with tempfile.TemporaryDirectory() as td:
        ctl, _ = build_controller(td, args.build_frames, args.device)
        if args.only_selected:
            for key in list(ctl.processors):
                if key not in KEYS:
                    del ctl.processors[key]
        if args.precompute:
            covered = sorted(ctl.enable_precomputed_playback())
            build_s = ctl.playback_cache.build_seconds
        if args.backend == "matplotlib":
            fps, fps_proc = measure_matplotlib(ctl, args.frames)
        else:
            fps = measure_pyqtgraph(ctl, args.frames)
    out = {
        "backend": args.backend,
        "device": str(ctl.device),
        "frames": args.frames,
        "fps": fps,
        "ms_per_tick": 1000.0 / fps,
        "cells": len(KEYS),
        "precompute": bool(args.precompute),
        "only_selected": bool(args.only_selected),
    }
    if ctl.device.type == "cuda":
        import torch

        out["card"] = torch.cuda.get_device_name(ctl.device)
    if fps_proc is not None:
        out["fps_processing_only"] = fps_proc
        out["processing_ms_per_tick"] = 1000.0 / fps_proc
        out["render_ms_per_tick"] = 1000.0 / fps - 1000.0 / fps_proc
    if args.precompute:
        out["covered_keys"] = covered
        out["precompute_build_s"] = build_s
        out["precompute_build_ms_per_frame"] = 1e3 * build_s / ctl.dataset_model.num_frames
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
