"""DBS traffic: a recorded flight resident in device memory, with each frame's velocity, sharpened in whole calls.

The mix gives ``frames`` and ``batch``.  Set-up builds the program's DBS
pipeline (``build_dbs_pipeline``) with the configuration's parameters,
makes the flight on the device from the seed (``port_bench/gen/dbs_flight.py``:
planes and each frame's velocity ``[frames, 3]`` float32) and runs the first
batch once, whose outputs are thrown away.

The window is a closed loop over the batches in turn, each at least once.
Each call's maps ``[batch, ns, D]`` float32 are copied into pinned host
memory (one slot a frame) without waiting, and the window ends in a
synchronize.  On the card the maps go to the host from a copy stream of
their own, as a recording job overlaps its output with the next batch: the
compute stream copies them into a device staging buffer, and the copy
stream takes them from there to the host while the next call runs, so the
103 MB a call on the host's bus are off the compute stream's path.
``frames_per_s`` is every frame whose map reached the host over the wall
time of the window.

The check samples ``sample_frames`` frames (drawn from the seed) of the
maps the last pass left and recomputes them with the plain reference
(``port_bench/reference/dbs.py``) from the same planes and velocities:

- ``gate_mismatch``: the share of sampled frames whose branch differs.  The
  program's branch is the one of the reference's two maps (sharpened or
  fallback) that its map lies nearer: the largest ``|map - ref|`` over that
  reference map's largest value;
- ``bin_mismatch``: of the (frame, DBS angle) pairs of the frames the
  reference sharpens, the share whose Doppler bin differs; the program's
  bins are ``DBSPipeline.doppler_bins`` of the velocities it was handed;
- ``map_error``: over the frames whose branches agree, the largest
  ``|map - ref|`` over the frame's largest reference value, taken over the
  DBS angles whose bins agree (every angle of a fallback frame).

In the program's place, when asked: the control (the reference in TF32),
or a planted fault: ``velocity_late`` (each frame handed the previous
frame's velocity, the first frame zero), and the harness's own names:
``unchanged`` (every map zero), ``half_batch`` (the second half of each
batch's maps zero), ``altered`` (each map's largest value swapped with the
one a range bin along).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.gen import dbs_flight
from port_bench.lib import compare
from port_bench.lib.trace import span
from port_bench.reference import dbs as ref_dbs
from port_bench.traffic.bulk import sample

FAULTS = ("velocity_late", "unchanged", "half_batch", "altered")


def build_pipeline(cfg, p: dict, device):
    """The program's DBS pipeline with the deployment's parameters."""
    from mmwave_radar_processing_tpu_torch.parallel import build_dbs_pipeline

    return build_dbs_pipeline(
        cfg, rx_antennas=tuple(int(a) for a in p["rx_antennas"]),
        num_angle_bins=int(p["num_angle_bins"]),
        num_dbs_angle_bins=int(p["num_dbs_angle_bins"]),
        min_x_y_vel_dbs=float(p["min_x_y_vel_dbs"]), chirp_idx=int(p["chirp_idx"]),
        reformat_input=bool(p["reformat_input"]), device=device)


def _relative(gap: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Per frame the largest of ``gap`` ``[F, ns, D]`` over the largest of ``want``; 0 where that is 0."""
    scale = want.max(axis=(1, 2))
    return np.where(scale > 0, gap.max(axis=(1, 2)) / np.where(scale > 0, scale, 1.0), 0.0)


def dbs_numbers(maps: np.ndarray, bins: np.ndarray, ref: ref_dbs.Maps) -> dict:
    """The check's numbers of host maps ``[F, ns, D]`` and Doppler bins ``[F, D]`` against the reference's."""
    sharp, plain, fast, r_bins = (t.cpu().numpy() for t in ref)
    maps = maps.astype(np.float64)
    sharp, plain = sharp.astype(np.float64), plain.astype(np.float64)
    branch = (_relative(np.abs(maps - sharp), sharp)
              <= _relative(np.abs(maps - plain), plain))  # the program sharpened
    agree = branch == fast
    same_bin = bins == r_bins  # [F, D]
    bin_mismatch = float(np.mean(~same_bin[fast])) if fast.any() else 0.0
    want = np.where(fast[:, None, None], sharp, plain)
    cols = same_bin | ~fast[:, None]  # the angles compared in each frame
    error = _relative(np.where(cols[:, None, :], np.abs(maps - want), 0.0), want)
    return {"gate_mismatch": float(np.mean(~agree)), "bin_mismatch": bin_mismatch,
            "map_error": float(error[agree].max()) if agree.any() else 0.0}


def _swap_peak(maps: torch.Tensor) -> torch.Tensor:
    """Each map ``[ns, D]`` with its largest value swapped with the one a range bin along."""
    b, ns, d = maps.shape
    flat = maps.reshape(b, -1).clone()
    peak = flat.argmax(dim=1)
    r = peak // d
    other = torch.where(r + 1 < ns, peak + d, peak - d)
    rows = torch.arange(b, device=maps.device)
    flat[rows, peak], flat[rows, other] = flat[rows, other], flat[rows, peak]
    return flat.view(b, ns, d)


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
        self.pipeline = None if self.control else build_pipeline(ctx.port_config(), self.p,
                                                                 ctx.device)
        f = dbs_flight.flight(cell.radar, self.n, ctx.seed, ctx.device)
        self.re, self.im, self.vels = f.re, f.im, f.vels
        self.vels_in = f.vels  # what the program is handed
        if self.fault == "velocity_late":
            self.vels_in = torch.cat([torch.zeros_like(f.vels[:1]), f.vels[:-1]])
        pin = ctx.device.type == "cuda"
        d = int(self.p["num_dbs_angle_bins"])
        self.host = torch.zeros((self.n, cell.radar.ns, d), pin_memory=pin)
        self.copier = None
        if pin:
            self.copier = torch.cuda.Stream(ctx.device)
            self.staging = torch.empty((self.batch, cell.radar.ns, d), device=ctx.device)
            self.ready, self.copied = torch.cuda.Event(), torch.cuda.Event()
        with torch.no_grad():
            self._copy_out(self._call(0), 0)  # the one shape this traffic uses; overwritten
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    def _call(self, start: int) -> torch.Tensor:
        """The maps of one batch from frame ``start``."""
        s = slice(start, start + self.batch)
        if self.control:
            return ref_dbs.maps(self.re[s], self.im[s], self.vels_in[s], self.cell.radar,
                                self.p, tf32=True).map()
        out = self.pipeline(self.re[s], self.im[s], self.vels_in[s])
        if self.fault == "unchanged":
            out = torch.zeros_like(out)
        elif self.fault == "half_batch":
            h = self.batch // 2
            out = torch.cat([out[:h], torch.zeros_like(out[h:])])
        elif self.fault == "altered":
            out = _swap_peak(out)
        return out

    def _copy_out(self, out: torch.Tensor, start: int) -> None:
        """Send one batch's maps to their host slots from frame ``start``, without waiting."""
        dst = self.host[start:start + self.batch]
        if self.copier is None:
            dst.copy_(out)
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(self.copied)  # the staging buffer's last maps have left
        self.staging.copy_(out)
        self.ready.record(compute)
        self.copier.wait_event(self.ready)
        with torch.cuda.stream(self.copier):
            dst.copy_(self.staging, non_blocking=True)
        self.copied.record(self.copier)

    def bins(self, idx: np.ndarray) -> np.ndarray:
        """The Doppler bins the program used for frames ``idx``."""
        v = self.vels_in[torch.as_tensor(idx, device=self.device)]
        if self.control:
            return ref_dbs.doppler_bins(v, self.cell.radar, self.p, tf32=True).cpu().numpy()
        return self.pipeline.doppler_bins(v).cpu().numpy()

    def window(self, window) -> dict:
        nb = self.n // self.batch
        k = 0
        window.start()
        with torch.no_grad():
            while True:
                start = (k % nb) * self.batch
                with span("pipeline"):
                    out = self._call(start)
                with span("copy_out"):
                    self._copy_out(out, start)
                k += 1
                if window.done(self.batch) and k >= nb:
                    break
            with span("sync"):
                wall = window.finish()
        frames = k * self.batch
        return {"frames_per_s": frames / wall, "attempted": frames, "failed": 0}

    def release(self) -> None:
        # the pipeline holds only its DFT matrices and grids: the check reads its Doppler bins
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self):
        idx = sample(self.n, int(self.cell.spec["sample_frames"]), self.seed)
        sel = torch.as_tensor(idx, device=self.device)
        with torch.no_grad():
            ref = ref_dbs.maps(self.re[sel], self.im[sel], self.vels[sel], self.cell.radar,
                               self.p)
            bins = self.bins(idx)
        return compare.checks(dbs_numbers(self.host.numpy()[idx], bins, ref),
                              self.cell.spec["limits"])
