"""Seeded flights of a down-facing IWR6843 ODS over flat ground that climbs, holds and cruises, on the device.

The altitude, frame by frame (20 Hz, ``DT`` = 0.05 s):

- takeoff at an altitude uniform in 0.30-0.45 m;
- then pairs of a ramp and a hold: each hold lasts 40-400 frames at a level
  uniform in 0.6-1.8 m, and the ramp before it climbs or descends from the
  previous level at a rate uniform in 0.1-0.5 m/s (at most: the ramp lasts
  a whole number of frames, the first ending one step from its start).  So
  the altimeter's ground gate ``[h, h / cos 60deg] = [h, 2h]`` stays inside
  the 3.94 m range extent, and a frame moves the ground by at most 25 mm,
  well inside the tracker's 0.4 m search limit.

The velocity, in the sensor's axes (``x`` along the boresight, towards the
ground; ``y`` along the azimuth row, ``z`` along the elevation column):

- ``x`` is minus the altitude's rate: a climb moves the ground away;
- ``(y, z)`` is ``port_bench/gen/dbs_flight.py``'s horizontal track drawn
  from the same generator (its ``(x, y)``: cruises of 60-240 frames at
  0.4-0.8 m/s on a heading each, hovers of 20-80 frames at most 0.15 m/s,
  jitter sigma 0.02 m/s); its third axis is not used.

Each frame's scene is ``port_bench/gen/scene.py``'s, at the frame's altitude
and velocity: the specular nadir return (RCS 6) receding at ``-v_x``, 32
ground patches on a cone of up to 55 degrees below the sensor, each with the
radial velocity ``-u . v`` the ego-motion gives it (RCS 0.5-1.5, dropped
beyond 95% of the range extent), 1 to 3 point targets anywhere in range
0.4-0.9 of the extent with radial velocities of their own, and noise of
sigma 0.05 on each part.  The signal is ``scene.py``'s formula, copied:
a target of range ``r``, radial velocity ``v`` and direction ``(uy, uz)``
adds at sample ``n`` of chirp ``m`` on virtual element ``(y, z)``
``rcs exp(i (2 pi f_b n / fs + 4 pi v m Tc / lambda + 4 pi r / lambda + phase - pi (y uy + z uz)))``,
phases formed in float64 and reduced modulo 2 pi before they are rounded to
float32.  Every random number comes from one ``torch.Generator`` on the
device seeded with the seed, the altitude first, then the horizontal track,
the targets and the noise, so the same seed on the same device gives the
same flight.  The RANSAC draws are another stream
(:func:`port_bench.gen.scene.gumbel` of :func:`port_bench.gen.scene.draws_seed`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from port_bench.gen import dbs_flight
from port_bench.gen.scene import (
    MAX_POINT_TARGETS,
    NOISE_SIGMA,
    NUM_PATCHES,
    TWO_PI,
    draws_seed,
    generator,
    gumbel,
)
from port_bench.reference.radar import ODS_RX_Y, ODS_RX_Z, ODS_TX_Y, ODS_TX_Z, Radar

DT = 0.05
TAKEOFF_M = (0.30, 0.45)
HOLD_M = (0.6, 1.8)
HOLD_FRAMES = (40, 400)
RATE_M_S = (0.1, 0.5)
C_M_S = 299_792_458.0


class Track(NamedTuple):
    altitude: torch.Tensor  # [n] float64: the true altitude of each frame
    vels: torch.Tensor  # [n, 3] float64: the ego velocity, sensor axes
    hold: torch.Tensor  # [n] bool: the frame lies in a hold


def track(n: int, g: torch.Generator, device) -> Track:
    """The altitude and velocity of every frame, drawn first from ``g``."""
    f64 = dict(dtype=torch.float64, device=device)
    pairs = n // HOLD_FRAMES[0] + 1
    u = torch.rand((pairs + 1, 3), generator=g, **f64)
    takeoff = TAKEOFF_M[0] + (TAKEOFF_M[1] - TAKEOFF_M[0]) * u[0, 0]
    level = HOLD_M[0] + (HOLD_M[1] - HOLD_M[0]) * u[1:, 0]
    hold_len = (HOLD_FRAMES[0] + (HOLD_FRAMES[1] - HOLD_FRAMES[0] + 1) * u[1:, 1]).long()
    rate = RATE_M_S[0] + (RATE_M_S[1] - RATE_M_S[0]) * u[1:, 2]
    start = torch.cat([takeoff.reshape(1), level[:-1]])
    ramp_len = torch.ceil((level - start).abs() / (rate * DT)).long().clamp_min(1)
    lengths = torch.stack([ramp_len, hold_len], dim=1).reshape(-1)
    seg = torch.repeat_interleave(torch.arange(2 * pairs, device=device), lengths)[:n]
    first = torch.cumsum(lengths, 0) - lengths
    step = (torch.arange(n, device=device) - first[seg] + 1).to(torch.float64)
    pair, hold = seg // 2, seg % 2 == 1
    slope = (level - start) / ramp_len.to(torch.float64)  # metres a frame
    altitude = torch.where(hold, level[pair], start[pair] + slope[pair] * step)
    horizontal = dbs_flight.track(n, g, device).vels[:, :2]
    rise = torch.where(hold, 0.0, slope[pair] / DT)
    vels = torch.cat([-rise[:, None], horizontal], dim=1)
    return Track(altitude, vels, hold)


def targets(radar: Radar, tr: Track, g: torch.Generator, device):
    """``(range, radial velocity, uy, uz, rcs, phase)`` ``[n, 1 + patches + point targets]`` float64."""
    f64 = dict(dtype=torch.float64, device=device)
    n = tr.altitude.shape[0]
    alt, ego = tr.altitude, tr.vels
    u = torch.rand((n, 1 + 5 * NUM_PATCHES + 7 * MAX_POINT_TARGETS), generator=g, **f64)
    nadir_phase = TWO_PI * u[:, 0]
    pu = u[:, 1:1 + 5 * NUM_PATCHES].reshape(n, NUM_PATCHES, 5)
    tu = u[:, 1 + 5 * NUM_PATCHES:].reshape(n, MAX_POINT_TARGETS, 7)

    cone = torch.deg2rad(55.0 * pu[..., 0])
    roll = TWO_PI * pu[..., 1]
    az = torch.atan2(torch.sin(cone) * torch.cos(roll), torch.cos(cone))
    el = torch.asin(torch.sin(cone) * torch.sin(roll))
    p_rng = alt[:, None] / torch.clamp_min(torch.cos(cone), 0.2)
    dirs = torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az),
                        torch.sin(el)], dim=-1)
    p_vel = -(dirs * ego[:, None, :]).sum(-1)
    p_rcs = torch.where(p_rng < 0.95 * radar.range_max, 0.5 + pu[..., 2], 0.0)
    p_phase = TWO_PI * pu[..., 3]

    count = 1 + torch.floor(3 * tu[:, 0, 6]).clamp_max(2)  # 1..3 a frame
    t_rng = (0.4 + 0.5 * tu[..., 0]) * radar.range_max
    t_az = 0.8 * (2 * tu[..., 1] - 1)
    t_el = 0.4 * (2 * tu[..., 2] - 1)
    t_vel = 0.5 * (2 * tu[..., 3] - 1) * radar.vel_max
    present = torch.arange(MAX_POINT_TARGETS, device=device)[None, :] < count[:, None]
    t_rcs = torch.where(present, 2.0 + 6.0 * tu[..., 4], 0.0)
    t_phase = torch.zeros_like(t_rng)

    def uy_uz(a, e):
        return torch.cos(e) * torch.sin(a), torch.sin(e)

    zeros = torch.zeros((n, 1), **f64)
    p_uy, p_uz = uy_uz(az, el)
    t_uy, t_uz = uy_uz(t_az, t_el)
    cat = lambda *xs: torch.cat(xs, dim=1)  # noqa: E731
    return (cat(alt[:, None], p_rng, t_rng), cat(-ego[:, :1], p_vel, t_vel),
            cat(zeros, p_uy, t_uy), cat(zeros, p_uz, t_uz),
            cat(torch.full((n, 1), 6.0, **f64), p_rcs, t_rcs),
            cat(nadir_phase[:, None], p_phase, t_phase))


def frames(radar: Radar, scene, g: torch.Generator, device, chunk: int = 256):
    """float32 planes ``(re, im)`` ``[n, rx, samples, chirps]`` of the targets ``scene`` (:func:`targets`)."""
    rng, vel, uy, uz, rcs, phase = scene
    n = rng.shape[0]
    rx, ns, nm = radar.frame_shape()
    f64 = dict(dtype=torch.float64, device=device)
    samples = torch.arange(ns, **f64)
    chirps = torch.arange(nm, **f64)
    slot = torch.arange(nm, device=device) % radar.cpl
    tx = torch.tensor(radar.tx_slots, device=device)[slot]  # [nm]
    y = torch.tensor(ODS_TX_Y, **f64)[tx][None, :] + torch.tensor(ODS_RX_Y[:rx], **f64)[:, None]
    z = torch.tensor(ODS_TX_Z, **f64)[tx][None, :] + torch.tensor(ODS_RX_Z[:rx], **f64)[:, None]
    re = torch.empty((n, rx, ns, nm), dtype=torch.float32, device=device)
    im = torch.empty_like(re)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        f_beat = 2.0 * radar.slope_hz_s * rng[s:e] / C_M_S  # [c, T]
        fast = torch.remainder(TWO_PI * f_beat[..., None] * samples / radar.fs_hz, TWO_PI)
        slow = (4 * math.pi * vel[s:e, :, None] * chirps * radar.chirp_period_s
                / radar.lambda_m)  # [c, T, nm]
        const = 4 * math.pi * rng[s:e] / radar.lambda_m + phase[s:e]  # [c, T]
        array = -math.pi * (y * uy[s:e, :, None, None] + z * uz[s:e, :, None, None])
        total = torch.remainder(slow[:, :, None, :] + const[..., None, None] + array, TWO_PI)
        right = torch.polar(rcs[s:e, :, None, None].expand_as(total), total)  # [c, T, rx, nm]
        left = torch.polar(torch.ones_like(fast), fast)  # [c, T, ns]
        cube = torch.matmul(left.transpose(1, 2).to(torch.complex64),
                            right.reshape(e - s, -1, rx * nm).to(torch.complex64))
        cube = cube.view(e - s, ns, rx, nm).permute(0, 2, 1, 3)
        noise = torch.randn((2, e - s, rx, ns, nm), generator=g, dtype=torch.float32,
                            device=device)
        re[s:e] = cube.real + NOISE_SIGMA * noise[0]
        im[s:e] = cube.imag + NOISE_SIGMA * noise[1]
    return re, im


class Flight(NamedTuple):
    re: torch.Tensor  # [n, rx, ns, chirps] float32
    im: torch.Tensor
    altitude: torch.Tensor  # [n] float32: the true altitude
    vels: torch.Tensor  # [n, 3] float32: the true ego velocity, sensor axes


def flight(radar: Radar, n: int, seed: int, device) -> Flight:
    """``n`` frames of one flight from ``seed``."""
    g = generator(seed, device)
    tr = track(n, g, device)
    re, im = frames(radar, targets(radar, tr, g, device), g, device)
    return Flight(re, im, tr.altitude.to(torch.float32), tr.vels.to(torch.float32))


def scores(n: int, trials: int, max_dets: int, seed: int, device) -> torch.Tensor:
    """The RANSAC draws of a flight: Gumbel scores ``float32 [n, trials, max_dets]`` from their own stream."""
    return gumbel((n, trials, max_dets), draws_seed(seed), device)
