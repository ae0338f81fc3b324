"""Velocity-analysis traffic: a recorded flight resident in device memory, analysed in whole calls.

The mix gives ``frames`` and ``batch``.  Set-up builds the program's
velocity analysis (``build_velocity_analysis_pipeline``) with the
configuration's settings, makes the flight on the device from the seed
(``port_bench/gen/ground_flight.py``: the planes) and the RANSAC draws of
every frame from a stream of their own (Gumbel scores ``[frames, trials,
max_dets]``), and runs the first batch once, whose outputs are thrown away.

The window is a closed loop over the batches in turn, each at least once.
A pass starts the altimeter at ``min_altitude_m`` and the carried estimate
at zeros, and chains each later batch of the pass through the previous
one's ``final_altitude`` and ``final_velocity``.  Each call's points, valid
flags, counts, altitudes, carried estimates and fits (R^2 and the inlier
fraction) go to pinned host memory (one slot a frame) without waiting: on
the card the compute stream copies them into device staging buffers and a
copy stream of their own takes them to the host while the next call runs.
``frames_per_s`` is every frame whose outputs reached the host over the
wall time of the window.

The check samples ``sample_frames`` frames (drawn from the seed) of the
outputs the last pass left and compares them with the plain reference
(``port_bench/reference/ground.py``) run over the whole flight on the same
planes and draws:

- ``altitude_mismatch``: the share of the flight's frames, every one, whose
  tracked altitude differs by more than 1 mm (a zoom step is about 6.5 mm,
  so this tells a different pick from rounding).  Every frame, not the
  sample: float32 rounds a zoom pick to the next bin now and then (about
  one frame in 20,000 on the card), so a count over 1024 frames could not
  tell that from a fault as cleanly as one over the flight;
- ``det_mismatch`` and ``angle_mismatch``: as ``lib/compare.py`` defines them;
- ``velocity_mismatch``: the share of sampled frames whose R^2 or inlier
  fraction differs by more than 1e-3, or whose carried estimate differs on
  any axis by more than 1 mm/s or ``ROUNDING_MARGIN`` times what a float32
  solve of its source frame's normal equations may err by, whichever is
  larger (``reference.ground.solve_rounding``: the reference fits in
  float64, and a fit whose inlier directions are nearly coplanar is known
  only to float32's roundoff times the square of their condition number);
- ``overflow``: the frames of the flight whose detections (the reference's,
  every one counted) exceed ``max_dets``.

In the program's place, when asked: the control (the reference in TF32), or
a planted fault: ``altitude_late`` (each frame handed back the previous
frame's altitude, the first the tracker's start), ``velocity_late`` (each
frame handed back the previous frame's carried estimate, the first the
start), and the harness's own names: ``unchanged`` (every output zero),
``half_batch`` (the second half of each batch's outputs zero) and
``altered`` (each frame's first point moved by one Doppler bin).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from port_bench.gen import ground_flight
from port_bench.lib import compare
from port_bench.lib.trace import span
from port_bench.reference import ground as ref_ground
from port_bench.traffic.bulk import sample

FAULTS = ("altitude_late", "velocity_late", "unchanged", "half_batch", "altered")
ALTITUDE_TOL_M = 1e-3
ROUNDING_MARGIN = 10.0  # over the float32 solve's error: measured within 0.95 of it


class Outputs(NamedTuple):
    """What a call hands the host, one slot a frame."""

    points: torch.Tensor  # float32 [B, K, 4]
    valid: torch.Tensor  # bool [B, K]
    count: torch.Tensor  # int32 [B]
    altitude: torch.Tensor  # float32 [B]
    velocity: torch.Tensor  # float32 [B, 3]: the carried estimate
    fit: torch.Tensor  # float32 [B, 2]: R^2 and the inlier fraction


def build_pipeline(cfg, s: dict, reformat_input: bool, device):
    """The program's velocity analysis with the deployment's settings (``reference.ground.settings``)."""
    from mmwave_radar_processing_tpu_torch.parallel import build_velocity_analysis_pipeline

    c = s["vel_cfar"]
    return build_velocity_analysis_pipeline(
        cfg, az_antenna_idxs=tuple(s["az_antennas"]), el_antenna_idxs=tuple(s["el_antennas"]),
        vel_cfar_params=dict(num_train=int(c["num_train"]), num_guard=int(c["num_guard"]),
                             rho=float(c["rho"]), alpha=float(c["alpha"])),
        min_altitude_m=s["min_altitude_m"], zoom_search_region_m=s["zoom_search_region_m"],
        altitude_search_limit_m=s["altitude_search_limit_m"], range_bias=s["range_bias"],
        precise_est_enabled=s["precise_est_enabled"], max_dets=s["max_dets"],
        num_angle_bins=s["num_angle_bins"], shift_az_resp=s["az_shift"],
        shift_el_resp=s["el_shift"], min_r2_threshold=s["min_r2"],
        min_inlier_percent=s["min_inlier_fraction"], min_samples=s["ransac_min_samples"],
        residual_threshold=s["ransac_residual_threshold"], max_trials=s["ransac_max_trials"],
        reformat_input=reformat_input, device=device)


def _late(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """``x`` one frame late: each frame's value is the previous frame's, the first frame ``first``."""
    return torch.cat([first.reshape(1, *x.shape[1:]).to(x.dtype), x[:-1]])


def ground_numbers(altitude: np.ndarray, out: dict, ref: ref_ground.Analysis, idx: np.ndarray,
                   radar, max_dets: int) -> dict:
    """The check's numbers of the flight's altitudes and the host outputs ``out`` of frames ``idx``, against the reference's."""
    sel = torch.as_tensor(idx, device=ref.altitude.device)
    r_alt = ref.altitude.cpu().numpy().astype(np.float64)
    nums = {"altitude_mismatch": float(np.mean(
        ~(np.abs(altitude.astype(np.float64) - r_alt) <= ALTITUDE_TOL_M)))}
    nums.update(compare.cloud_numbers(out["points"], out["valid"], ref.points[sel].cpu().numpy(),
                                      ref.valid[sel].cpu().numpy(), range_res=radar.range_res,
                                      vel_max=radar.vel_max, vel_res=radar.vel_res))
    r_fit = torch.stack([ref.r2, ref.inlier_fraction], dim=-1)[sel].cpu().numpy()
    r_vel = ref.velocity[sel].cpu().numpy()
    tol = np.maximum(compare.VELOCITY_TOL_M_S,
                     ROUNDING_MARGIN * ref_ground.solve_rounding(ref)[1][sel].cpu().numpy())
    gap = np.max(np.abs(out["velocity"].astype(np.float64) - r_vel), axis=1)
    apart = ~(gap <= tol) | ~(np.max(np.abs(out["fit"].astype(np.float64) - r_fit), axis=1)
                              <= compare.FIT_TOL)
    nums["velocity_mismatch"] = float(np.mean(apart))
    nums["overflow"] = float((ref.count > max_dets).sum())
    return nums


class Run:
    UNITS = {"frames_per_s": "frames/s"}

    def __init__(self, ctx):
        cell = ctx.cell
        self.cell, self.seed, self.device = cell, ctx.seed, ctx.device
        self.radar = cell.radar
        self.s = ref_ground.settings(cell.config["processing"])
        self.dims = 2 if cell.config["array_geometry"] == "standard" else 3
        self.n, self.batch = int(cell.mix["frames"]), int(cell.mix["batch"])
        if self.n % self.batch:
            raise ValueError(f"frames {self.n} is not a whole number of batches of {self.batch}")
        if ctx.fault is not None and ctx.fault not in FAULTS:
            raise ValueError(f"unknown fault {ctx.fault!r}, expected one of {FAULTS}")
        self.fault, self.control = ctx.fault, ctx.control
        self.pipeline = None if self.control else build_pipeline(
            ctx.port_config(), self.s, bool(cell.config["processing"]["reformat_input"]),
            ctx.device)
        f = ground_flight.flight(self.radar, self.n, ctx.seed, ctx.device)
        self.re, self.im = f.re, f.im
        k = self.s["max_dets"]
        self.scores = ground_flight.scores(self.n, self.s["ransac_max_trials"], k, ctx.seed,
                                           ctx.device)
        pin = ctx.device.type == "cuda"
        shapes = Outputs((k, 4), (k,), (), (), (3,), (2,))
        dtypes = Outputs(torch.float32, torch.bool, torch.int32, torch.float32, torch.float32,
                         torch.float32)
        self.host = Outputs(*(torch.zeros((self.n, *sh), dtype=dt, pin_memory=pin)
                              for sh, dt in zip(shapes, dtypes)))
        self.copier = None
        if pin:
            self.copier = torch.cuda.Stream(ctx.device)
            self.staging = Outputs(*(torch.empty((self.batch, *sh), dtype=dt, device=ctx.device)
                                     for sh, dt in zip(shapes, dtypes)))
            self.ready, self.copied = torch.cuda.Event(), torch.cuda.Event()
        self.carry = None
        with torch.no_grad():
            self._copy_out(self._call(0), 0)  # the one shape this traffic uses; overwritten
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    def _start(self):
        """The carries a batch starts from: the tracker's start and zeros at a pass's start, else the last batch's."""
        if self.carry is not None:
            return self.carry
        return (torch.full((), self.s["min_altitude_m"], dtype=torch.float32, device=self.device),
                torch.zeros(3, dtype=torch.float32, device=self.device))

    def _call(self, start: int) -> Outputs:
        """The outputs of one batch from frame ``start``, chained to the previous batch of the pass."""
        if start == 0:
            self.carry = None
        alt0, vel0 = self._start()
        s = slice(start, start + self.batch)
        if self.control:
            a = ref_ground.analysis(self.re[s], self.im[s], self.scores[s], self.radar, self.s,
                                    dims=self.dims, tf32=True, init_altitude=float(alt0),
                                    init_velocity=vel0.cpu().numpy())
            out = Outputs(a.points, a.valid, a.count.clamp_max(self.s["max_dets"]).to(
                torch.int32), a.altitude, a.velocity, torch.stack([a.r2, a.inlier_fraction], -1))
            self.carry = (a.altitude[-1] - self.s["range_bias"], a.velocity[-1])
        else:
            o = self.pipeline(self.re[s], self.im[s], scores=self.scores[s], init_altitude=alt0,
                              init_velocity=vel0)
            out = Outputs(o.points, o.valid, o.count, o.altitude, o.velocity,
                          torch.stack([o.r2, o.inlier_fraction], dim=-1))
            self.carry = (o.final_altitude, o.final_velocity)
        if self.fault == "altitude_late":
            out = out._replace(altitude=_late(out.altitude, alt0 + self.s["range_bias"]))
        elif self.fault == "velocity_late":
            out = out._replace(velocity=_late(out.velocity, vel0))
        elif self.fault == "altered":
            points = out.points.clone()
            points[:, 0, 3] += self.radar.vel_res
            out = out._replace(points=points)
        elif self.fault == "unchanged":
            out = Outputs(*(torch.zeros_like(t) for t in out))
        elif self.fault == "half_batch":
            h = self.batch // 2
            out = Outputs(*(torch.cat([t[:h], torch.zeros_like(t[h:])]) for t in out))
        return out

    def _copy_out(self, out: Outputs, start: int) -> None:
        """Send one batch's outputs to their host slots from frame ``start``, without waiting."""
        dst = [t[start:start + self.batch] for t in self.host]
        if self.copier is None:
            for d, t in zip(dst, out):
                d.copy_(t)
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(self.copied)  # the staging buffers' last outputs have left
        for st, t in zip(self.staging, out):
            st.copy_(t)
        self.ready.record(compute)
        self.copier.wait_event(self.ready)
        with torch.cuda.stream(self.copier):
            for d, st in zip(dst, self.staging):
                d.copy_(st, non_blocking=True)
        self.copied.record(self.copier)

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
        # the flight's mean detections and gated rows a frame, for the roofline's bound
        lo, hi = ref_ground.gated_rows(self.host.altitude, self.radar)
        return {"frames_per_s": frames / wall, "attempted": frames, "failed": 0,
                "dets_per_frame": float(self.host.count.double().mean()),
                "gated_rows_per_frame": float((hi - lo + 1).double().mean())}

    def release(self) -> None:
        # the pipeline holds only its DFT matrices and grids
        self.carry = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self):
        idx = sample(self.n, int(self.cell.spec["sample_frames"]), self.seed)
        with torch.no_grad():
            ref = ref_ground.analysis(self.re, self.im, self.scores, self.radar, self.s,
                                      dims=self.dims)
        out = {name: t.numpy()[idx] for name, t in zip(Outputs._fields, self.host)}
        return compare.checks(ground_numbers(self.host.altitude.numpy(), out, ref, idx, self.radar,
                                             self.s["max_dets"]), self.cell.spec["limits"])
