"""The plain reference of the synthetic-aperture depth maps: each sampled frame's aperture built anew.

Plain PyTorch in float32, independent of the program under test.  For a
frame ``t`` of a recording it takes frames ``t-F+1 ... t`` of the selected
receiver and chirps, and their velocities (zero frames and velocities
before the recording's start), and computes, in blocks of frames:

- the velocity gate: every ``|v|`` within ``[min_vel, max_vel]``, each
  axis' population standard deviation at most ``max_vel_stdev``, every
  pairwise cosine of the directions ``v / (|v| + 1e-6)`` above 0.95;
- the element positions, chained backward from the newest frame at the
  origin: chirp ``c`` of frame ``f`` at ``2 t_c v_f + pose_f``,
  ``pose_{f-1} = pose_f - 2 v_f T_frame``, ``t_c <= 0`` counted from the
  frame's last chirp;
- the steering phases ``2 pi (d . p) / lambda`` over the azimuth-major
  grid of directions ``d``, and the element sum
  ``b[n, a] = sum_e w_e x[n, e] exp(j phase[a, e])`` with a Hamming window
  over the ``F*C`` elements;
- the Hann-windowed range DFT and the magnitude ``sqrt(re^2 + im^2)``;
- the depth map of the plotter: per direction the first range bin of the
  largest magnitude and that magnitude; the bin is -1 where
  ``20 log10(peak + 1e-12)`` lies more than the floor below the frame's
  largest such value, or where the gate fails (and the peak is then 0).

Every product (the phases' ``d . p``, the element sum, the DFT) is a real
float32 matrix product of :func:`port_bench.reference.dsp.matmul`, so that
``tf32=True`` rounds all their operands to TF32: the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from port_bench.reference.dsp import cmatmul, dft_matrix, magnitude, matmul
from port_bench.reference.radar import Radar


class Depth(NamedTuple):
    depth_bin: torch.Tensor  # [N, A] int32
    peak: torch.Tensor  # [N, A] float32
    ok: torch.Tensor  # [N] bool


def frame_period_s(cfg_lines: Sequence[str]) -> float:
    """The frame period of a ``.cfg``'s ``frameCfg`` line (its fifth field, in ms)."""
    for line in cfg_lines:
        tokens = line.split()
        if tokens and tokens[0] == "frameCfg" and "%" not in line:
            return float(tokens[5]) * 1e-3
    raise ValueError("no frameCfg line")


def selected_chirps(radar: Radar, chirp_cfg_idx: int, stride: int) -> np.ndarray:
    """The chirps of chirp configuration ``chirp_cfg_idx`` in a frame, every ``stride``-th."""
    slots = np.tile(np.asarray(radar.tx_slots), radar.loops)
    return np.flatnonzero(slots == chirp_cfg_idx)[::stride]


def angles_rad(grid: Sequence[float]) -> np.ndarray:
    """float64 bins of a ``[first deg, last deg, count]`` grid."""
    return np.deg2rad(np.linspace(float(grid[0]), float(grid[1]), int(grid[2])))


def directions(p: dict, device=None) -> torch.Tensor:
    """float32 ``(A, 3)`` unit vectors ``(cos az cos el, sin az cos el, sin el)``, azimuth major."""
    az, el = np.meshgrid(angles_rad(p["az_deg"]), angles_rad(p["el_deg"]), indexing="ij")
    d = np.stack([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)], axis=-1)
    return torch.tensor(d.reshape(-1, 3), dtype=torch.float32, device=device)


def gate(vel: torch.Tensor, p: dict) -> torch.Tensor:
    """The velocity gate of ``[B, F, 3]`` float32 histories -> bool ``[B]``."""
    lo, hi, sd = (torch.tensor(p[k], dtype=torch.float32, device=vel.device)
                  for k in ("min_vel", "max_vel", "max_vel_stdev"))
    mag = vel.abs()
    within = ((mag >= lo) & (mag <= hi)).all(dim=-1).all(dim=-1)
    mean = vel.mean(dim=1, keepdim=True)
    std = ((vel - mean) ** 2).mean(dim=1).sqrt()
    steady = (std <= sd).all(dim=-1)
    norm = (vel * vel).sum(dim=-1, keepdim=True).sqrt()
    u = vel / (norm + 1e-6)
    cosines = (u[:, :, None, :] * u[:, None, :, :]).sum(dim=-1)  # [B, F, F]
    aligned = (cosines > 0.95).all(dim=-1).all(dim=-1)
    return within & steady & aligned


def positions(vel: torch.Tensor, chirp_times_s: torch.Tensor, frame_dt: float) -> torch.Tensor:
    """Element positions ``[B, 3, F*C]`` of ``[B, F, 3]`` histories, element ``f*C + c``."""
    b, f, _ = vel.shape
    pose = torch.zeros((b, 3), dtype=torch.float32, device=vel.device)
    frames = [None] * f
    for i in range(f - 1, -1, -1):
        frames[i] = 2.0 * chirp_times_s[None, None, :] * vel[:, i, :, None] + pose[:, :, None]
        pose = pose - 2.0 * vel[:, i] * frame_dt
    return torch.cat(frames, dim=-1)


def _windows(re, im, vels, t: torch.Tensor, p: dict, chirps: torch.Tensor):
    """The apertures of frames ``t``: planes ``[B, ns, F*C]`` and velocities ``[B, F, 3]``."""
    f = int(p["num_frames"])
    idx = t[:, None] + torch.arange(-f + 1, 1, device=t.device)[None, :]  # [B, F]
    before = (idx < 0)
    safe = idx.clamp_min(0)
    rx = int(p["receiver_idx"])
    planes = []
    for plane in (re, im):
        x = plane[safe, rx][..., chirps]  # [B, F, ns, C]
        x = torch.where(before[:, :, None, None], 0.0, x)
        planes.append(x.permute(0, 2, 1, 3).reshape(x.shape[0], x.shape[2], -1))
    vel = torch.where(before[:, :, None], 0.0, vels[safe].to(torch.float32))
    return planes, vel


def depth_maps(re: torch.Tensor, im: torch.Tensor, vels: torch.Tensor, frames, radar: Radar,
               p: dict, frame_dt: float, *, tf32: bool = False, block: int = 32) -> Depth:
    """The depth map of each of ``frames`` (indices into the recording ``re``/``im`` ``[N, rx, ns, chirps]``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = re.device
    t_all = torch.as_tensor(np.asarray(frames), device=device, dtype=torch.int64)
    chirp_idx = selected_chirps(radar, int(p["chirp_cfg_idx"]), int(p["stride"]))
    chirps = torch.as_tensor(chirp_idx, device=device)
    n_chirps = radar.chirps
    chirp_times = torch.tensor((chirp_idx - (n_chirps - 1)) * radar.chirp_period_s,
                               dtype=torch.float32, device=device)
    e = int(p["num_frames"]) * len(chirp_idx)
    window = torch.tensor(np.hamming(e), dtype=torch.float32, device=device)
    d = directions(p, device)
    mr, mi = dft_matrix(radar.ns, radar.ns, window=np.hanning(radar.ns), device=device)
    scale = 2 * math.pi / radar.lambda_m
    floor = float(p["depth_floor_db"])
    out = []
    for s in range(0, len(t_all), block):
        t = t_all[s:s + block]
        (xr, xi), vel = _windows(re, im, vels, t, p, chirps)
        ok = gate(vel, p)
        phase = matmul(d, positions(vel, chirp_times, frame_dt), tf32) * scale  # [B, A, E]
        steer = (torch.cos(phase).transpose(1, 2), torch.sin(phase).transpose(1, 2))
        beam = cmatmul((xr * window, xi * window), steer, tf32)  # [B, ns, A]
        spec = cmatmul((mr.T, mi.T), beam, tf32)
        mag = magnitude(spec)
        peak, depth_bin = mag.max(dim=1)
        db = 20 * torch.log10(peak + 1e-12)
        keep = (db >= db.amax(dim=-1, keepdim=True) - floor) & ok[:, None]
        out.append(Depth(torch.where(keep, depth_bin, -1).to(torch.int32),
                         torch.where(ok[:, None], peak, 0.0), ok))
    return Depth(*(torch.cat(parts) for parts in zip(*out)))
