"""Synthetic-aperture traffic: a recorded flight resident in device memory, streamed through in batches.

The mix gives ``frames`` and ``batch``.  Set-up builds the program's
synthetic-aperture pipeline with the configuration's parameters and its
depth head (``output="depth"``), makes the flight on the device from the
seed (``port_bench/gen/flight.py``: planes and each frame's velocity) and
runs the first batch once, whose outputs are thrown away.

The window is a closed loop of passes over the flight, each batch at
least once.  A pass takes the batches in order and carries the aperture
(the last ``F-1`` frames and velocities) from each call to the next; it
starts from the pipeline's zero state.  Each call's depth bins, peaks and
gate are copied into pinned host buffers (one slot a frame) without
waiting, and the window ends in a synchronize.  ``frames_per_s`` is every
frame whose outputs reached the host over the wall time of the window.

The check samples ``sample_frames`` frames (drawn from the seed) of the
outputs the last pass left and recomputes them with the plain reference
(``port_bench/reference/sar.py``), each from its own aperture of the whole
recording:

- ``gate_mismatch``: the share of sampled frames whose gate differs;
- ``depth_mismatch``: of the (frame, direction) cells of frames that pass
  on both sides, the share whose depth bin differs (the floor included);
- ``peak_error``: over those frames, the largest ``|peak - ref|`` over the
  frame's largest reference peak.

In the program's place, when asked: the control (the reference in TF32),
or a planted fault: ``aperture_reset`` (every batch starts from the zero
state), ``history_late`` (the velocity of each frame handed over one frame
late), ``depth_off`` (each frame's first direction above the floor moved
one range bin), and the harness's own names: ``unchanged`` (every output
zero), ``half_batch`` (the second half of each batch's outputs zero),
``altered`` (as ``depth_off``).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.gen import flight
from port_bench.lib import compare
from port_bench.lib.trace import span
from port_bench.reference import sar as ref_sar
from port_bench.traffic.bulk import sample

FAULTS = ("aperture_reset", "history_late", "depth_off", "unchanged", "half_batch", "altered")


def build_pipeline(cfg, p: dict, device):
    """The program's synthetic-aperture pipeline with the deployment's parameters and its depth head."""
    from mmwave_radar_processing_tpu_torch.parallel import build_synthetic_aperture_pipeline

    return build_synthetic_aperture_pipeline(
        cfg, receiver_idx=int(p["receiver_idx"]), chirp_cfg_idx=int(p["chirp_cfg_idx"]),
        num_frames=int(p["num_frames"]), stride=int(p["stride"]),
        az_angle_bins_rad=ref_sar.angles_rad(p["az_deg"]),
        el_angle_bins_rad=ref_sar.angles_rad(p["el_deg"]), min_vel=np.asarray(p["min_vel"]),
        max_vel=np.asarray(p["max_vel"]), max_vel_stdev=np.asarray(p["max_vel_stdev"]),
        output="depth", depth_floor_db=float(p["depth_floor_db"]), device=device)


def sar_numbers(depth_bin, peak, ok, ref: ref_sar.Depth) -> dict:
    """The check's numbers of host outputs ``[F, A]``, ``[F, A]``, ``[F]`` against the reference's."""
    r_bin, r_peak, r_ok = (t.cpu().numpy() for t in ref)
    ok, r_ok = ok.astype(bool), r_ok.astype(bool)
    both = ok & r_ok
    depth = float(np.mean(depth_bin[both] != r_bin[both])) if both.any() else 0.0
    peak_error = 0.0
    if both.any():
        gap = np.abs(peak[both].astype(np.float64) - r_peak[both]).max(axis=1)
        scale = r_peak[both].astype(np.float64).max(axis=1)
        peak_error = float(np.max(np.where(scale > 0, gap / np.where(scale > 0, scale, 1), 0)))
    return {"gate_mismatch": float(np.mean(ok != r_ok)), "depth_mismatch": depth,
            "peak_error": peak_error}


def _depth_off(out: ref_sar.Depth, ns: int) -> ref_sar.Depth:
    """Each frame's first direction above the floor, one range bin along."""
    depth = out.depth_bin.clone()
    valid = depth >= 0
    first = torch.argmax(valid.to(torch.int32), dim=1)
    rows = torch.nonzero(valid.any(dim=1)).squeeze(1)
    moved = depth[rows, first[rows]]
    depth[rows, first[rows]] = torch.where(moved + 1 < ns, moved + 1, moved - 1)
    return out._replace(depth_bin=depth)


class Run:
    UNITS = {"frames_per_s": "frames/s"}

    def __init__(self, ctx):
        cell = ctx.cell
        self.cell, self.seed, self.device = cell, ctx.seed, ctx.device
        self.p = cell.config["processing"]
        self.n, self.batch = int(cell.mix["frames"]), int(cell.mix["batch"])
        if self.n % self.batch:
            raise ValueError(f"frames {self.n} is not a whole number of batches of {self.batch}")
        if ctx.fault is not None and ctx.fault not in FAULTS:
            raise ValueError(f"unknown fault {ctx.fault!r}, expected one of {FAULTS}")
        self.fault, self.control = ctx.fault, ctx.control
        self.frame_dt = ref_sar.frame_period_s(cell.config["cfg_lines"])
        self.pipeline = None if self.control else build_pipeline(ctx.port_config(), self.p,
                                                                 ctx.device)
        f = flight.flight(cell.radar, self.frame_dt, self.n, ctx.seed, ctx.device)
        self.re, self.im, self.vels = f.re, f.im, f.vels
        self.vels_in = f.vels  # what the program is handed
        if self.fault == "history_late":
            self.vels_in = torch.cat([torch.zeros_like(f.vels[:1]), f.vels[:-1]])
        pin = ctx.device.type == "cuda"
        a = len(ref_sar.angles_rad(self.p["az_deg"])) * len(ref_sar.angles_rad(self.p["el_deg"]))
        self.host = ref_sar.Depth(torch.zeros((self.n, a), dtype=torch.int32, pin_memory=pin),
                                  torch.zeros((self.n, a), pin_memory=pin),
                                  torch.zeros(self.n, dtype=torch.bool, pin_memory=pin))
        with torch.no_grad():
            self._call(0, self._start())  # the one shape this traffic uses; outputs discarded
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    def _start(self):
        return None if self.control else self.pipeline.init_state()

    def _call(self, start: int, state):
        """One batch from frame ``start``: ``(Depth, state after it)``."""
        s = slice(start, start + self.batch)
        if self.control:
            ref = ref_sar.depth_maps(self.re, self.im, self.vels, np.arange(s.start, s.stop),
                                     self.cell.radar, self.p, self.frame_dt, tf32=True)
            return ref, None
        if self.fault == "aperture_reset":
            state = self.pipeline.init_state()
        out, state = self.pipeline(self.re[s], self.im[s], self.vels_in[s], state)
        out = ref_sar.Depth(*out)
        if self.fault in ("depth_off", "altered"):
            out = _depth_off(out, self.cell.radar.ns)
        elif self.fault == "unchanged":
            out = ref_sar.Depth(*(torch.zeros_like(t) for t in out))
        elif self.fault == "half_batch":
            h = self.batch // 2
            out = ref_sar.Depth(*(torch.cat([t[:h], torch.zeros_like(t[h:])]) for t in out))
        return out, state

    def window(self, window) -> dict:
        nb = self.n // self.batch
        k, state = 0, None
        window.start()
        with torch.no_grad():
            while True:
                start = (k % nb) * self.batch
                if start == 0:
                    state = self._start()
                with span("pipeline"):
                    out, state = self._call(start, state)
                with span("copy_out"):
                    for host, value in zip(self.host, out):
                        host[start:start + self.batch].copy_(value, non_blocking=True)
                k += 1
                if window.done(self.batch) and k >= nb:
                    break
            with span("sync"):
                wall = window.finish()
        frames = k * self.batch
        return {"frames_per_s": frames / wall, "attempted": frames, "failed": 0}

    def release(self) -> None:
        del self.pipeline
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self):
        idx = sample(self.n, int(self.cell.spec["sample_frames"]), self.seed)
        with torch.no_grad():
            ref = ref_sar.depth_maps(self.re, self.im, self.vels, idx, self.cell.radar, self.p,
                                     self.frame_dt)
        host = [t.numpy()[idx] for t in self.host]
        return compare.checks(sar_numbers(*host, ref), self.cell.spec["limits"])
