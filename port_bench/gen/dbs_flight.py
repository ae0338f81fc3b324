"""Seeded flights of a down-facing IWR6843 ODS that cruises and hovers over static scatterers, on the device.

The velocity track, in the axes of the DBS pipeline's velocities (``x``
along the array's boresight, ``y`` along its azimuth row, ``z`` along its
elevation column, so that a look direction of azimuth ``theta`` has
``r_hat = (cos theta, sin theta)`` in the ``xy`` plane):

- segments alternate between cruise and hover, the flight starting with a
  cruise;
- a cruise lasts 60-240 frames at a speed ``|v_xy|`` uniform in 0.4-0.8 m/s
  on a heading uniform on the circle, both drawn per segment;
- a hover lasts 20-80 frames at a drift uniform in 0-0.1 m/s on a heading of
  its own, and ``|v_xy|`` is clipped to 0.15 m/s;
- every frame adds a jitter of sigma 0.02 m/s to ``x`` and ``y``, and ``v_z``
  is normal with sigma 0.05 m/s.

With the DBS gate at 0.25 m/s a cruise frame is sharpened and a hover frame
falls back to the plain map, so the fallback share is the hover share,
about 25%.

The scene of each frame: 32-64 static scatterers (drawn per frame; the
unused slots of 64 carry no return) at a range uniform from 0.5 m to 0.95 of
the range extent, azimuth within +-60 degrees, elevation within +-20
degrees, RCS 0.5-3 and a phase of their own.  A scatterer in direction
``u = (cos el cos az, cos el sin az, sin el)`` recedes at ``-u . v``, the
frame's velocity.  The signal is ``port_bench/gen/scene.py``'s model: the
same formula, with its ODS antenna tables and its noise of sigma 0.05 on
each part, phases formed in float64 and reduced modulo 2 pi before they are
rounded to float32.  Every random number comes from one ``torch.Generator``
on the device seeded with the seed, the track first, so the same seed on the
same device gives the same flight.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from port_bench.gen.scene import NOISE_SIGMA, TWO_PI, generator
from port_bench.reference.radar import ODS_RX_Y, ODS_RX_Z, ODS_TX_Y, ODS_TX_Z, Radar

CRUISE_FRAMES = (60, 240)
HOVER_FRAMES = (20, 80)
CRUISE_SPEED = (0.4, 0.8)
HOVER_DRIFT = 0.1
HOVER_MAX = 0.15
JITTER = 0.02
VZ_SIGMA = 0.05
SCATTERERS = (32, 64)
#: the nearest range in metres, and the farthest as a share of the range extent
RANGE_MIN_M, RANGE_MAX_SHARE = 0.5, 0.95
AZ_DEG, EL_DEG = 60.0, 20.0
RCS = (0.5, 3.0)
C_M_S = 299_792_458.0


class Track(NamedTuple):
    vels: torch.Tensor  # [n, 3] float64: each frame's velocity
    cruise: torch.Tensor  # [n] bool: the frame lies in a cruise segment


def track(n: int, g: torch.Generator, device) -> Track:
    """The velocity of every frame, drawn first from ``g``."""
    f64 = dict(dtype=torch.float64, device=device)
    pairs = n // (CRUISE_FRAMES[0] + HOVER_FRAMES[0]) + 1
    u = torch.rand((pairs, 6), generator=g, **f64)
    jitter = torch.randn((n, 3), generator=g, **f64) * torch.tensor([JITTER, JITTER, VZ_SIGMA],
                                                                    **f64)
    cruise_len = (CRUISE_FRAMES[0] + (CRUISE_FRAMES[1] - CRUISE_FRAMES[0] + 1) * u[:, 0]).long()
    hover_len = (HOVER_FRAMES[0] + (HOVER_FRAMES[1] - HOVER_FRAMES[0] + 1) * u[:, 1]).long()
    cruise_speed = CRUISE_SPEED[0] + (CRUISE_SPEED[1] - CRUISE_SPEED[0]) * u[:, 2]
    speed = torch.stack([cruise_speed, HOVER_DRIFT * u[:, 4]], dim=1).reshape(-1)
    heading = TWO_PI * torch.stack([u[:, 3], u[:, 5]], dim=1).reshape(-1)
    lengths = torch.stack([cruise_len, hover_len], dim=1).reshape(-1)
    cruise = torch.tensor([True, False], device=device).repeat(pairs)
    seg = torch.repeat_interleave(torch.arange(2 * pairs, device=device), lengths)[:n]
    vels = jitter.clone()
    vels[:, 0] += (speed * torch.cos(heading))[seg]
    vels[:, 1] += (speed * torch.sin(heading))[seg]
    xy = vels[:, :2].norm(dim=1)
    clip = torch.where(cruise[seg], 1.0, torch.clamp(HOVER_MAX / xy.clamp_min(1e-12), max=1.0))
    vels[:, :2] *= clip[:, None]
    return Track(vels, cruise[seg])


class Scatterers(NamedTuple):
    """Each frame's scatterers, float64 ``[n, T]``; a slot of RCS 0 returns nothing."""

    range_m: torch.Tensor
    az: torch.Tensor
    el: torch.Tensor
    rcs: torch.Tensor
    phase: torch.Tensor


def scatterers(radar: Radar, n: int, g: torch.Generator, device) -> Scatterers:
    """32-64 scatterers a frame in the slots of ``SCATTERERS[1]``."""
    f64 = dict(dtype=torch.float64, device=device)
    t = SCATTERERS[1]
    u = torch.rand((n, t, 5), generator=g, **f64)
    count = SCATTERERS[0] + torch.floor(
        (SCATTERERS[1] - SCATTERERS[0] + 1) * torch.rand((n, 1), generator=g, **f64))
    r0, r1 = RANGE_MIN_M, RANGE_MAX_SHARE * radar.range_max
    present = torch.arange(t, device=device)[None, :] < count
    return Scatterers(r0 + (r1 - r0) * u[..., 0],
                      math.radians(AZ_DEG) * (2 * u[..., 1] - 1),
                      math.radians(EL_DEG) * (2 * u[..., 2] - 1),
                      torch.where(present, RCS[0] + (RCS[1] - RCS[0]) * u[..., 3], 0.0),
                      TWO_PI * u[..., 4])


def frames(radar: Radar, s: Scatterers, vels: torch.Tensor, g: torch.Generator, device,
           chunk: int = 256):
    """float32 planes ``(re, im)`` ``[n, rx, samples, chirps]`` of scatterers ``s`` seen at velocities ``vels``.

    ``gen/scene.py``'s signal: a scatterer of range ``r``, radial velocity
    ``v`` and direction ``(uy, uz)`` adds at sample ``k`` of chirp ``m`` on
    virtual element ``(y, z)``
    ``rcs exp(i (2 pi f_b k / fs + 4 pi v m Tc / lambda + 4 pi r / lambda + phase - pi (y uy + z uz)))``.
    """
    f64 = dict(dtype=torch.float64, device=device)
    n = vels.shape[0]
    rx, ns, nm = radar.frame_shape()
    cos_el = torch.cos(s.el)
    u = torch.stack([cos_el * torch.cos(s.az), cos_el * torch.sin(s.az), torch.sin(s.el)], -1)
    radial = -(u * vels.to(torch.float64)[:, None, :]).sum(-1)  # [n, T]
    uy, uz = u[..., 1], u[..., 2]
    samples = torch.arange(ns, **f64)
    chirps = torch.arange(nm, **f64)
    slot = torch.arange(nm, device=device) % radar.cpl
    tx = torch.tensor(radar.tx_slots, device=device)[slot]  # [nm]
    y = torch.tensor(ODS_TX_Y, **f64)[tx][None, :] + torch.tensor(ODS_RX_Y[:rx], **f64)[:, None]
    z = torch.tensor(ODS_TX_Z, **f64)[tx][None, :] + torch.tensor(ODS_RX_Z[:rx], **f64)[:, None]
    re = torch.empty((n, rx, ns, nm), dtype=torch.float32, device=device)
    im = torch.empty_like(re)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        f_beat = 2.0 * radar.slope_hz_s * s.range_m[a:b] / C_M_S  # [c, T]
        fast = torch.remainder(TWO_PI * f_beat[..., None] * samples / radar.fs_hz, TWO_PI)
        slow = 4 * math.pi * radial[a:b, :, None] * chirps * radar.chirp_period_s / radar.lambda_m
        const = 4 * math.pi * s.range_m[a:b] / radar.lambda_m + s.phase[a:b]  # [c, T]
        array = -math.pi * (y * uy[a:b, :, None, None] + z * uz[a:b, :, None, None])
        total = torch.remainder(slow[:, :, None, :] + const[..., None, None] + array, TWO_PI)
        right = torch.polar(s.rcs[a:b, :, None, None].expand_as(total), total)  # [c, T, rx, nm]
        left = torch.polar(torch.ones_like(fast), fast)  # [c, T, ns]
        cube = torch.matmul(left.transpose(1, 2).to(torch.complex64),
                            right.reshape(b - a, -1, rx * nm).to(torch.complex64))
        cube = cube.view(b - a, ns, rx, nm).permute(0, 2, 1, 3)
        noise = torch.randn((2, b - a, rx, ns, nm), generator=g, dtype=torch.float32,
                            device=device)
        re[a:b] = cube.real + NOISE_SIGMA * noise[0]
        im[a:b] = cube.imag + NOISE_SIGMA * noise[1]
    return re, im


class Flight(NamedTuple):
    re: torch.Tensor  # [n, rx, ns, chirps] float32
    im: torch.Tensor
    vels: torch.Tensor  # [n, 3] float32: the velocity that set each frame's Doppler


def flight(radar: Radar, n: int, seed: int, device) -> Flight:
    """``n`` frames of one flight from ``seed``."""
    g = generator(seed, device)
    tr = track(n, g, device)
    vels = tr.vels.to(torch.float32)
    re, im = frames(radar, scatterers(radar, n, g, device), vels, g, device)
    return Flight(re, im, vels)
