"""Plain reference of the batched ego-velocity estimate (the RadVel ODS ADC path).

Per frame, written out directly:

1. the altitude window: ``W = min(ns, ceil((lower+upper)/range_res) + 2)``
   range rows from the first bin at or above ``altitude - lower``, clipped
   to fit, weighted by the rows within ``[altitude - lower, altitude + upper]``
   (the weights sum to 1);
2. the Hann-windowed range DFT of those rows and the Hann-windowed,
   fftshifted chirp DFT of all 12 virtual channels;
3. per velocity bin and angle bin, the weighted sum over the window rows of
   the magnitude of a 64-bin angle DFT over each 4-antenna sub-array, the
   two azimuth and the two elevation sub-arrays each averaged, angles kept
   within the valid range;
4. in dB, floored ``peak_threshold_db`` below each response's maximum;
5. ``vx``: minus the velocity of the highest zero-azimuth local maximum
   (the mean where both responses have one);
6. per velocity row the highest local maximum of prominence at least 4 dB;
7. one RANSAC ``vy`` fit a response on the given draws (``vx >= 0.1``:
   ``-v - vx cos(a) = vy sin(a)``; otherwise ``a = (v - vx) * c``,
   ``vy = -1/c``), gated on R^2 and the inlier fraction.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from port_bench.reference import dsp
from port_bench.reference.radar import Radar, angle_bins

MIN_PROMINENCE_DB = 4.0
MIN_SAMPLES = 10


class Velocity(NamedTuple):
    velocity: torch.Tensor  # float32 [B, 3]: gated az vy, el vy, vx
    fit: torch.Tensor  # float32 [B, 4]: R^2 az, R^2 el, inlier fraction az, el


def _window(altitude, radar: Radar, lower: float, upper: float):
    """``(start [B], weights [B, W])`` of the altitude window, in float32 as the deployment runs it."""
    dev = altitude.device
    w_rows = min(radar.ns, int(math.ceil((lower + upper) / radar.range_res)) + 2)
    bins = torch.tensor(radar.range_bins(), dtype=torch.float32, device=dev)
    lo = torch.clamp_min(altitude - lower, 0.0)
    hi = torch.clamp_max(altitude + upper, radar.range_max)
    start = (bins[None, :] < lo[:, None]).sum(1).clamp(0, radar.ns - w_rows)
    j = torch.arange(w_rows, dtype=torch.float32, device=dev)
    row_m = (start.float()[:, None] + j) * radar.range_res
    inside = ((row_m >= lo[:, None]) & (row_m <= hi[:, None])).float()
    return start, inside / torch.clamp_min(inside.sum(1, keepdim=True), 1.0)


def velocity_block(raw_re, raw_im, altitude, gumbel, radar: Radar, p: Dict,
                   tf32: bool) -> Velocity:
    dev = raw_re.device
    b = raw_re.shape[0]
    v = p["velocity"]
    start, wgt = _window(altitude, radar, v["lower_range_bound"], v["upper_range_bound"])
    w_rows = wgt.shape[1]
    x = (dsp.virtual_cube(raw_re, radar.num_rx, radar.cpl),
         dsp.virtual_cube(raw_im, radar.num_rx, radar.cpl))  # [B, 12, ns, loops]
    rng = dsp.dft_matrix(radar.ns, radar.ns, window=np.hanning(radar.ns), device=dev)
    r = dsp.cmatmul((rng[0].T.contiguous(), rng[1].T.contiguous()), x, tf32)
    rows = start[:, None] + torch.arange(w_rows, device=dev)  # [B, W]
    gather = rows[:, None, :, None].expand(b, r[0].shape[1], w_rows, radar.loops)
    r = (torch.gather(r[0], 2, gather), torch.gather(r[1], 2, gather))  # [B, 12, W, loops]
    chirp = dsp.dft_matrix(radar.loops, radar.loops, shift=True,
                           window=np.hanning(radar.loops), device=dev)
    u = dsp.cmatmul(r, chirp, tf32)  # [B, 12, W, nv]

    nb = v["num_angle_bins"]
    bins = angle_bins(nb)
    lo, hi = np.deg2rad(v["valid_angle_deg"][0]), np.deg2rad(v["valid_angle_deg"][1])
    cols = np.flatnonzero((bins >= lo) & (bins <= hi))
    valid_bins = torch.tensor(bins[cols], dtype=torch.float32, device=dev)
    zero_col = int(np.argmin(np.abs(bins[cols])))

    def response(channels, shift):
        m = dsp.dft_matrix(len(channels), nb, shift=shift, device=dev)
        m = (m[0][:, cols].contiguous(), m[1][:, cols].contiguous())
        idx = list(channels)
        # [B, W, nv, 4] @ [4, Av] -> [B, W, nv, Av]
        s = (u[0][:, idx].permute(0, 2, 3, 1), u[1][:, idx].permute(0, 2, 3, 1))
        mag = dsp.magnitude(dsp.cmatmul(s, m, tf32))
        return (wgt[:, :, None, None] * mag).sum(1)  # [B, nv, Av]

    az = 0.5 * (response(v["az_sets"][0], True) + response(v["az_sets"][1], True))
    el = 0.5 * (response(v["el_sets"][0], False) + response(v["el_sets"][1], False))
    resp = torch.stack([az, el], dim=1)  # [B, 2, nv, Av]
    db = 20.0 * torch.log10(resp + 1e-12)
    db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - v["peak_threshold_db"])

    vel_bins = torch.tensor(radar.vel_bins(), dtype=torch.float32, device=dev)
    col = db[..., zero_col]  # [B, 2, nv]
    peak = dsp.local_maxima(col)
    best = torch.argmax(torch.where(peak, col, float("-inf")), dim=-1)
    found = peak.any(-1)
    speed = torch.where(found, vel_bins[best], 0.0)
    both = found[:, 0] & found[:, 1]
    vx = torch.where(both, -0.5 * (speed[:, 0] + speed[:, 1]),
                     torch.where(found[:, 0], -speed[:, 0],
                                 torch.where(found[:, 1], -speed[:, 1], 0.0)))

    row_peak = dsp.local_maxima(db) & (dsp.prominence(db) >= MIN_PROMINENCE_DB)
    best_col = torch.argmax(torch.where(row_peak, db, float("-inf")), dim=-1)  # [B, 2, nv]
    has_peak = row_peak.any(-1)
    ang = valid_bins[best_col]

    std = (vx >= 0.1)[:, None, None]
    vels = vel_bins[None, None, :]
    vx3 = vx[:, None, None]
    y = torch.where(std, -vels - vx3 * torch.cos(ang), ang)
    h = torch.where(std, torch.sin(ang), vels - vx3)
    thr = torch.where(vx >= 0.1, 0.15, 0.20)[:, None].expand(b, 2)
    fit = dsp.ransac_1d(h, y, has_peak, gumbel, min_samples=MIN_SAMPLES, threshold=thr)
    a = fit.coef
    vy = torch.where((vx >= 0.1)[:, None], a,
                     torch.where(fit.ok & (a != 0.0), -1.0 / a, 0.0))
    keep = (fit.r2 >= v["min_r2"]) & (fit.inlier_fraction >= v["min_inlier_fraction"])
    gated = torch.where(keep, vy, 0.0)
    return Velocity(torch.stack([gated[:, 0], gated[:, 1], vx], dim=-1),
                    torch.cat([fit.r2, fit.inlier_fraction], dim=-1))


def velocity(raw_re, raw_im, altitude, gumbel, radar: Radar, p: Dict, *,
             tf32: bool = False, block: int = 16) -> Velocity:
    """The reference estimate of ``[B, rx, ns, chirps]`` planes, ``[B]`` altitudes and ``[B, 2, T, nv]`` draws."""
    parts = [velocity_block(raw_re[i:i + block], raw_im[i:i + block], altitude[i:i + block],
                            gumbel[i:i + block], radar, p, tf32)
             for i in range(0, raw_re.shape[0], block)]
    return Velocity(*(torch.cat(t) for t in zip(*parts)))
