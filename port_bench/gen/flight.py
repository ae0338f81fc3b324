"""Seeded flights of a forward-flying UAV radar over stationary reflectors, simulated on the device.

The track, frame by frame (``T_frame`` from the configuration):

- cruise segments of 120-280 frames at a nominal ``vx`` drawn once per
  flight in 0.20-0.22 m/s, inside the synthetic-aperture gate;
- between them segments of 10-40 frames outside it: a hover (nominal
  velocity 0) or a speed-up (nominal ``vx`` 0.32-0.40 m/s), each with
  probability one half; a flight starts with a cruise;
- on every frame and axis a jitter of sigma 0.01 m/s around the nominal
  velocity.  The velocity of frame ``f`` holds over the period that ends
  with its last chirp, and the platform's position is integrated along the
  track from the origin: chirp ``k`` of frame ``f`` sits at
  ``x_end(f) - (N_chirps - 1 - k) T_chirp v_f``.

The scene: reflectors fixed in the world, uniform in a corridor around the
track, at a density that puts ``K`` of them (drawn per flight in 16-48)
in view on average.  In view means at 1-10 m, azimuth within +-30 degrees
and elevation within +-15 degrees of the platform at the frame's end
(azimuth ``atan2(dy, dx)``, elevation ``asin(dz / r)``).  A reflector in
view returns amplitude ``a (2 m / r)^2`` with ``a`` uniform in 0.5-2 and
a phase of its own; out of view it returns nothing.

Each chirp's phase is the two-way path to the reflector from the platform
at that chirp, ``4 pi r / lambda``, plus the virtual element's offset in
half wavelengths across the array, ``-pi (y_tx + y_rx) u_y`` (IWR1843 in the
standard layout: receivers at 0-3, TX1 at 0 and TX3 at 4); the beat
frequency ``2 slope r / c`` comes from the range at the frame's end.  So
the aperture focuses as in a real flight.  Complex Gaussian noise of sigma
0.05 on each part.  Phases are formed in float64 and reduced modulo 2 pi
before they are rounded to float32.  Every random number comes from one
``torch.Generator`` on the device seeded with the seed, the track first, so
the same seed on the same device gives the same flight.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from port_bench.gen.scene import generator
from port_bench.reference.radar import Radar

CRUISE_FRAMES = (120, 280)
OFF_FRAMES = (10, 40)
CRUISE_VX = (0.20, 0.22)
SPEEDUP_VX = (0.32, 0.40)
JITTER = 0.01
REFLECTORS_IN_VIEW = (16, 48)
RANGE_M = (1.0, 10.0)
AZ_DEG, EL_DEG = 30.0, 15.0
AMPLITUDE = (0.5, 2.0)
NOISE_SIGMA = 0.05
#: IWR1843 standard layout, half wavelengths along y: receivers, and the transmitters by chirp slot
RX_Y = (0.0, 1.0, 2.0, 3.0)
TX_Y = (0.0, 4.0)
TWO_PI = 2 * math.pi
C_M_S = 299_792_458.0


class Track(NamedTuple):
    vels: torch.Tensor  # [n, 3] float64: each frame's velocity
    cruise: torch.Tensor  # [n] bool: the frame lies in a cruise segment


def track(n: int, g: torch.Generator, device) -> Track:
    """The velocity of every frame, drawn first from ``g``."""
    f64 = dict(dtype=torch.float64, device=device)
    pairs = n // (CRUISE_FRAMES[0] + OFF_FRAMES[0]) + 1
    u = torch.rand((pairs, 4), generator=g, **f64)
    vx0 = CRUISE_VX[0] + (CRUISE_VX[1] - CRUISE_VX[0]) * torch.rand((), generator=g, **f64)
    jitter = JITTER * torch.randn((n, 3), generator=g, **f64)
    cruise_len = (CRUISE_FRAMES[0] + (CRUISE_FRAMES[1] - CRUISE_FRAMES[0] + 1) * u[:, 0]).long()
    off_len = (OFF_FRAMES[0] + (OFF_FRAMES[1] - OFF_FRAMES[0] + 1) * u[:, 1]).long()
    speedup_vx = SPEEDUP_VX[0] + (SPEEDUP_VX[1] - SPEEDUP_VX[0]) * u[:, 3]
    off_vx = torch.where(u[:, 2] < 0.5, 0.0, speedup_vx)
    lengths = torch.stack([cruise_len, off_len], dim=1).reshape(-1)
    nominal_vx = torch.stack([vx0.expand(pairs), off_vx], dim=1).reshape(-1)
    cruise = torch.tensor([True, False], device=device).repeat(pairs)
    seg = torch.repeat_interleave(torch.arange(2 * pairs, device=device), lengths)[:n]
    vels = jitter.clone()
    vels[:, 0] += nominal_vx[seg]
    return Track(vels, cruise[seg])


def _reflectors(x_span: Tuple[float, float], in_view: torch.Tensor, g, device):
    """World positions ``[R, 3]`` sorted by x, amplitudes and phases of the corridor's reflectors."""
    f64 = dict(dtype=torch.float64, device=device)
    r0, r1 = RANGE_M
    view_sr = math.radians(2 * AZ_DEG) * 2 * math.sin(math.radians(EL_DEG))
    view_m3 = (r1 ** 3 - r0 ** 3) / 3 * view_sr
    y_half, z_half = r1 * math.sin(math.radians(AZ_DEG)) + 1, r1 * math.sin(math.radians(EL_DEG)) + 1
    x0, x1 = x_span[0] - 1.0, x_span[1] + r1 + 1.0
    volume = (x1 - x0) * 2 * y_half * 2 * z_half
    count = int(torch.ceil(in_view * volume / view_m3).item())
    u = torch.rand((count, 5), generator=g, **f64)
    pos = torch.stack([x0 + (x1 - x0) * u[:, 0], y_half * (2 * u[:, 1] - 1),
                       z_half * (2 * u[:, 2] - 1)], dim=1)
    amp = AMPLITUDE[0] + (AMPLITUDE[1] - AMPLITUDE[0]) * u[:, 3]
    order = torch.argsort(pos[:, 0])
    return pos[order], amp[order], TWO_PI * u[order, 4]


class Flight(NamedTuple):
    re: torch.Tensor  # [n, rx, ns, chirps] float32
    im: torch.Tensor
    vels: torch.Tensor  # [n, 3] float32
    cruise: torch.Tensor  # [n] bool
    in_view: torch.Tensor  # [n] int64: reflectors in view at each frame's end


def flight(radar: Radar, frame_dt: float, n: int, seed: int, device, chunk: int = 32) -> Flight:
    """``n`` frames of one flight from ``seed``."""
    g = generator(seed, device)
    f64 = dict(dtype=torch.float64, device=device)
    tr = track(n, g, device)
    k_view = REFLECTORS_IN_VIEW[0] + (REFLECTORS_IN_VIEW[1] - REFLECTORS_IN_VIEW[0]) * torch.rand(
        (), generator=g, **f64)
    rx, ns, nm = radar.frame_shape()
    x_end = torch.cumsum(tr.vels * frame_dt, dim=0)  # [n, 3]
    back = (nm - 1 - torch.arange(nm, **f64)) * radar.chirp_period_s  # [nm]
    pos, amp, phase0 = _reflectors((float(x_end[:, 0].min()), float(x_end[:, 0].max())),
                                   k_view, g, device)
    slot = torch.arange(nm, device=device) % radar.cpl
    y_virt = torch.tensor(TX_Y, **f64)[slot][None, :] + torch.tensor(RX_Y[:rx], **f64)[:, None]
    samples = torch.arange(ns, **f64)
    az_max, el_max = math.radians(AZ_DEG), math.radians(EL_DEG)

    re = torch.empty((n, rx, ns, nm), dtype=torch.float32, device=device)
    im = torch.empty_like(re)
    in_view = torch.zeros(n, dtype=torch.int64, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        lo = torch.searchsorted(pos[:, 0].contiguous(), x_end[s:e, 0].min() - 1.0)
        hi = torch.searchsorted(pos[:, 0].contiguous(), x_end[s:e, 0].max() + RANGE_M[1] + 1.0)
        p, a, ph = pos[lo:hi], amp[lo:hi], phase0[lo:hi]  # [R, ...]
        rel_end = p[None] - x_end[s:e, None, :]  # [c, R, 3]
        r_end = rel_end.norm(dim=-1)
        az = torch.atan2(rel_end[..., 1], rel_end[..., 0])
        el = torch.asin((rel_end[..., 2] / r_end).clamp(-1, 1))
        seen = ((r_end >= RANGE_M[0]) & (r_end <= RANGE_M[1]) & (az.abs() <= az_max)
                & (el.abs() <= el_max))
        in_view[s:e] = seen.sum(dim=1)
        gain = torch.where(seen, a * (2.0 / r_end) ** 2, 0.0)  # [c, R]
        u_y = rel_end[..., 1] / r_end
        # the platform at every chirp, and the range from it
        at_chirp = x_end[s:e, None, :] - back[None, :, None] * tr.vels[s:e, None, :]  # [c, nm, 3]
        r = (p[None, None] - at_chirp[:, :, None, :]).norm(dim=-1)  # [c, nm, R]
        slow = (4 * math.pi * r.transpose(1, 2)[:, :, None, :] / radar.lambda_m
                - math.pi * y_virt[None, None] * u_y[..., None, None]
                + ph[None, :, None, None])  # [c, R, rx, nm]
        f_beat = 2.0 * radar.slope_hz_s * r_end / C_M_S
        fast = torch.remainder(TWO_PI * f_beat[..., None] * samples / radar.fs_hz, TWO_PI)
        right = torch.polar(gain[:, :, None, None].expand_as(slow), torch.remainder(slow, TWO_PI))
        left = torch.polar(torch.ones_like(fast), fast)  # [c, R, ns]
        cube = torch.matmul(left.transpose(1, 2).to(torch.complex64),
                            right.reshape(e - s, -1, rx * nm).to(torch.complex64))
        cube = cube.view(e - s, ns, rx, nm).permute(0, 2, 1, 3)
        noise = torch.randn((2, e - s, rx, ns, nm), generator=g, dtype=torch.float32,
                            device=device)
        re[s:e] = cube.real + NOISE_SIGMA * noise[0]
        im[s:e] = cube.imag + NOISE_SIGMA * noise[1]
    return Flight(re, im, tr.vels.to(torch.float32), tr.cruise, in_view)
