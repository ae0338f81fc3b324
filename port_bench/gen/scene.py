"""Seeded scenes of a down-facing UAV radar, simulated on the device.

The scene model of the upstream-style simulator (``data/simulator.py`` of the
port at the time this benchmark was written), frozen here so that later
changes to the program cannot change the traffic.  Each frame holds:

- a specular nadir return at the altitude (RCS 6), receding at ``-vx``;
- 32 ground patches on a cone of up to 55 degrees below the sensor, each
  with the radial velocity the ego-motion gives it (RCS 0.5-1.5); patches
  beyond 95% of the range extent are dropped;
- 1 to 3 point targets anywhere in range 0.4-0.9 of the extent, azimuth
  within 0.8 rad, elevation within 0.4 rad, radial velocity within half the
  extent (RCS 2-8);
- complex Gaussian noise of sigma 0.05 on each part.

The altitude is uniform in 0.9-1.3 m and the ego velocity normal with
sigmas (0.3, 0.2, 0.1) m/s.  A target of range ``r``, radial velocity
``v`` and direction ``(uy, uz)`` adds, at sample ``n`` of chirp ``m`` on
virtual element ``(y, z)`` (half wavelengths),

    rcs * exp(i (2 pi f_b n / fs + 4 pi v m Tc / lambda + 4 pi r / lambda
                 + phase - pi (y uy + z uz))),    f_b = 2 slope r / c

which factors into a ``[samples, targets] @ [targets, rx*chirps]`` product
per frame.  Phases are formed in float64 and reduced modulo 2 pi before
they are rounded to float32.  Every random number comes from one
``torch.Generator`` on the device seeded with ``seed``, drawn in a few large
calls, so the same seed on the same device gives the same frames.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from port_bench.reference.radar import ODS_RX_Y, ODS_RX_Z, ODS_TX_Y, ODS_TX_Z, Radar

NUM_PATCHES = 32
MAX_POINT_TARGETS = 3
NOISE_SIGMA = 0.05
TWO_PI = 2 * math.pi


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _targets(radar: Radar, n: int, g: torch.Generator, device):
    """``(range, radial velocity, uy, uz, rcs, phase)`` ``[n, T]`` float64 and the altitudes ``[n]``."""
    f64 = dict(dtype=torch.float64, device=device)
    u = torch.rand((n, 2 + 5 * NUM_PATCHES + 7 * MAX_POINT_TARGETS), generator=g, **f64)
    ego = torch.randn((n, 3), generator=g, **f64) * torch.tensor([0.3, 0.2, 0.1], **f64)
    alt = 0.9 + 0.4 * u[:, 0]
    nadir_phase = TWO_PI * u[:, 1]
    pu = u[:, 2:2 + 5 * NUM_PATCHES].reshape(n, NUM_PATCHES, 5)
    tu = u[:, 2 + 5 * NUM_PATCHES:].reshape(n, MAX_POINT_TARGETS, 7)

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
    n_uy, n_uz = zeros, zeros
    p_uy, p_uz = uy_uz(az, el)
    t_uy, t_uz = uy_uz(t_az, t_el)
    cat = lambda *xs: torch.cat(xs, dim=1)  # noqa: E731
    return (cat(alt[:, None], p_rng, t_rng), cat(-ego[:, :1], p_vel, t_vel),
            cat(n_uy, p_uy, t_uy), cat(n_uz, p_uz, t_uz),
            cat(torch.full((n, 1), 6.0, **f64), p_rcs, t_rcs),
            cat(nadir_phase[:, None], p_phase, t_phase)), alt


def frames(radar: Radar, n: int, seed: int, device, chunk: int = 512
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n`` frames: float32 planes ``(re, im)`` ``[n, rx, samples, chirps]`` and altitudes ``[n]``."""
    g = generator(seed, device)
    (rng, vel, uy, uz, rcs, phase), alt = _targets(radar, n, g, device)
    rx, ns, nm = radar.frame_shape()
    re = torch.empty((n, rx, ns, nm), dtype=torch.float32, device=device)
    im = torch.empty_like(re)
    f64 = dict(dtype=torch.float64, device=device)
    samples = torch.arange(ns, **f64)
    chirps = torch.arange(nm, **f64)
    slot = torch.arange(nm, device=device) % radar.cpl
    tx = torch.tensor(radar.tx_slots, device=device)[slot]  # [nm]
    y = torch.tensor(ODS_TX_Y, **f64)[tx][None, :] + torch.tensor(ODS_RX_Y[:rx], **f64)[:, None]
    z = torch.tensor(ODS_TX_Z, **f64)[tx][None, :] + torch.tensor(ODS_RX_Z[:rx], **f64)[:, None]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        f_beat = 2.0 * radar.slope_hz_s * rng[s:e] / 299_792_458.0  # [c, T]
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
    return re, im, alt.to(torch.float32)


def gumbel(shape, seed: int, device) -> torch.Tensor:
    """Standard Gumbel scores of ``shape`` (float32) for the RANSAC trials, from their own seed."""
    g = generator(seed, device)
    u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def draws_seed(seed: int) -> int:
    """The seed of a run's RANSAC draws: another stream than its frames'."""
    return (int(seed) * 1_000_003 + 7) % (2 ** 63)

