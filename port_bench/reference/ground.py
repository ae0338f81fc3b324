"""Plain reference of RadVel's velocity analysis over a recording: altimeter, ground point cloud, points ego-velocity.

Plain PyTorch in float32 with TF32 off, independent of the program under
test: it transforms with FFTs (``torch.fft``), not with DFT matrices, takes
the altimeter's zoom as a direct DTFT of the one band the tracker needs, and
ranks the CFAR's training cells by sorting them.  It follows upstream's
per-frame flow, ``scripts/test_vel_estimation.py`` at
``analyzer_configs/velocity_analysis_config.yaml``; per frame of the
recording, in order:

1. the altimeter (upstream ``processors/altimeter.py:42-140``): the loop-0
   chirp of every virtual channel, its Hann-windowed range FFT, the mean
   magnitude over channels in dB, and its three strongest prominent peaks (a
   strict local maximum whose prominence, scipy's over the whole row, is at
   least 6 dB, and which lies within 20 dB of the strongest such peak).  The
   ground peak is the lowest of them at or above ``min_altitude_m`` and within
   ``altitude_search_limit_m`` of the tracked altitude.  When there is one,
   the zoom: a DTFT of the Hann-windowed chirps over ``[peak - zoom, peak +
   zoom]`` (clipped into ``(1e-6, last range bin - 1e-6)``) at ``ns``
   frequencies ``f1 + k (f2 - f1) / ns`` (scipy's ``ZoomFFT``), labelled
   ``lo + i (hi - lo) / (ns - 1)`` as upstream labels them; of its two
   strongest prominent peaks the lowest within the same gate is the new
   altitude when it is positive, else the altitude stays.  Without a ground
   peak it stays.  The recursion runs as a loop over host floats, frame by
   frame, from ``min_altitude_m``; the output is the altitude plus
   ``range_bias``;
2. the ground detector (upstream ``range_doppler_ground_detector.py:72-121``):
   the Hann-windowed range FFT and the Hann-windowed, fftshifted Doppler FFT
   of virtual channel 0, and its magnitude; the rows from the bin nearest the
   altitude to the bin nearest ``min(last bin, altitude / cos 60deg)``; along
   each such row the OS-CFAR: a cell at least ``train + guard`` from both ends
   is detected where it exceeds ``alpha`` times the ``k``-th smallest of its
   ``2 train`` training cells, ``k = clamp(int(rho 2 train), 1, 2 train)``;
3. the detections in row-major order, each one's azimuth and elevation from
   the argmax of the zero-padded angle FFT over its antenna subset (the
   azimuth's fftshifted), and the FLU point ``(x, y, z, velocity)``
   (upstream ``point_cloud_generator.py:143-248``);
4. the points ``VelocityEstimator`` (upstream ``vel_estimator.py:76-181``):
   RANSAC of ``-velocity = (p / |p|) . v`` over the points, 3D for the ODS
   geometry and 2D ``(x, y)`` for the standard one, then the gates (R^2 and
   the inlier share each at least its threshold); a frame keeps the last
   estimate that passed, zeros before the first.

Departures from upstream, each one the program's too unless it says otherwise:

- upstream keeps every detection; here the first ``max_dets`` in row-major
  order, a capacity the traffic sizes so that no frame drops one (``count``
  is every detection, so a caller can count the frames that would);
- RANSAC's samples come from the Gumbel scores handed in (``[T, trials,
  max_dets]``, one row of scores a slot): a trial's sample is the ``k =
  min(min_samples, max_dets)`` valid slots of the highest scores, every
  valid slot where fewer are valid; sklearn draws from its own random state;
- the winner is the first maximum of the float32 key ``inliers * 1e6 + R^2
  + trial * 1e-9``, the port's rule (kept from the JAX package): from 17
  inliers on float32 rounds the R^2 away, so the first trial of the most
  inliers wins.  sklearn takes the higher R^2 among equal inlier counts, a
  rule that picks another trial, and so another fit, on 4-11% of the
  frames of these flights;
- a fit with fewer than ``min_samples`` valid points reads 0, and the
  winner's R^2 reads 0 from 3 inliers down (upstream skips the fit: both then
  keep the last estimate, as the gates fail);
- float32 throughout (upstream's numpy runs float64), but for two parts:
  the zoom's phases, formed in float64 as scipy's ``ZoomFFT`` forms them and
  rounded once (the program forms them in float32, which moves a zoom bin's
  magnitude by about 1e-5 of itself and so, now and then, a near-tie pick by
  one zoom bin); and the RANSAC, which runs on the host in float64 as
  upstream's does: the points' directions, each least-squares fit by the SVD
  (:func:`_lstsq`, scipy's ``lstsq``), the residuals, the inlier test and
  R^2, with the results rounded to float32.  The program solves float32
  normal equations instead, so a point whose residual lies within rounding
  of the threshold can flip a trial's inlier count and so the winner: that
  is the one way the two fits differ by more than rounding.

With ``tf32=True`` every product's operands are first rounded to TF32
(:func:`port_bench.reference.dsp.round_tf32`): each window product, the
inputs of each FFT, the zoom's data and factors, the fit's directions and
targets, and each fit before its residuals are formed.  That is the
control.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from port_bench.reference.dsp import local_maxima, prominence, round_tf32, virtual_cube
from port_bench.reference.radar import Radar, angle_bins

MIN_PROMINENCE_DB = 6.0
THRESHOLD_DB = 20.0
COS_60 = math.cos(math.radians(60.0))
EPS64 = float(torch.finfo(torch.float64).eps)
F32_ROUNDOFF = 2.0 ** -24


def settings(processing: Dict) -> Dict:
    """The flat settings of a configuration's ``processing`` (the analyzer config's ``processors``, and what is assumed)."""
    pcg = processing["point_cloud_generator"]
    det = pcg["detector_params"]
    alt = det["altimeter_params"]
    vel = processing["velocity_estimator"]
    ransac = processing["ransac"]
    return dict(
        az_antennas=list(pcg["az_antenna_idxs"]), el_antennas=list(pcg["el_antenna_idxs"]),
        az_shift=bool(pcg["shift_az_resp"]), el_shift=bool(pcg["shift_el_resp"]),
        vel_cfar=dict(det["vel_cfar_params"]),
        min_altitude_m=float(alt["min_altitude_m"]),
        zoom_search_region_m=float(alt["zoom_search_region_m"]),
        altitude_search_limit_m=float(alt["altitude_search_limit_m"]),
        range_bias=float(alt["range_bias"]), precise_est_enabled=bool(alt["precise_est_enabled"]),
        min_r2=float(vel["min_r2_threshold"]), min_inlier_fraction=float(vel["min_inlier_percent"]),
        max_dets=int(processing["max_dets"]), num_angle_bins=int(processing["num_angle_bins"]),
        ransac_min_samples=int(ransac["min_samples"]),
        ransac_residual_threshold=float(ransac["residual_threshold"]),
        ransac_max_trials=int(ransac["max_trials"]))


class Analysis(NamedTuple):
    altitude: torch.Tensor  # float32 [T]: tracked altitude + range_bias
    points: torch.Tensor  # float32 [T, K, 4]
    valid: torch.Tensor  # bool [T, K]
    count: torch.Tensor  # int64 [T]: every detection, the capacity aside
    proposed: torch.Tensor  # float32 [T, 3]: each frame's fit
    r2: torch.Tensor  # float32 [T]
    inlier_fraction: torch.Tensor  # float32 [T]
    velocity: torch.Tensor  # float32 [T, 3]: the carried estimate
    kappa: torch.Tensor  # float32 [T]: condition number of the directions of the winner's inliers
    source: torch.Tensor  # int64 [T]: the frame whose proposal the carried estimate is, -1 the start


def _r(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``x`` (real or complex float32), rounded to TF32 where asked."""
    if not tf32:
        return x
    if x.is_complex():
        return torch.complex(round_tf32(x.real), round_tf32(x.imag))
    return round_tf32(x)


def _hann(n: int, device) -> torch.Tensor:
    return torch.tensor(np.hanning(n), dtype=torch.float32, device=device)


def _db(mag: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(mag + 1e-12)


def prominent_peaks(db: torch.Tensor, max_peaks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``max_peaks`` strongest prominent peaks of ``[..., N]``: indices by descending value, and valid flags."""
    ok = local_maxima(db) & (prominence(db) >= MIN_PROMINENCE_DB)
    best = torch.where(ok, db, float("-inf")).amax(dim=-1, keepdim=True)
    ok = ok & (db >= best - THRESHOLD_DB)
    vals, idx = torch.sort(torch.where(ok, db, float("-inf")), dim=-1, descending=True,
                           stable=True)
    return idx[..., :max_peaks], torch.isfinite(vals[..., :max_peaks])


def plain_range_bins(radar: Radar) -> np.ndarray:
    """float32 ``arange(0, range_max - res/2, res)``: the altimeter's grid (upstream ``range_resp.py``)."""
    return np.arange(0.0, radar.range_max - radar.range_res / 2, radar.range_res).astype(
        np.float32)


def loop0_chirps(re: torch.Tensor, im: torch.Tensor, radar: Radar) -> torch.Tensor:
    """complex64 ``[T, V, ns]``: the first loop's chirp of every virtual channel."""
    first = torch.complex(re[..., :radar.cpl], im[..., :radar.cpl])
    return virtual_cube(first, radar.num_rx, radar.cpl)[..., 0]


def coarse_candidates(chirps: torch.Tensor, radar: Radar, tf32: bool):
    """The altimeter's coarse peaks of ``[T, V, ns]``: ranges ``[T, 3]`` float32 (0 where none) and valid flags."""
    w = _hann(radar.ns, chirps.device)
    spec = torch.fft.fft(_r(_r(chirps, tf32) * _r(w, tf32), tf32), dim=-1)
    idx, ok = prominent_peaks(_db(spec.abs().mean(dim=-2)), 3)
    bins = torch.as_tensor(plain_range_bins(radar), device=chirps.device)
    return torch.where(ok, bins[idx], 0.0), ok


def zoom_peaks(chirps: torch.Tensor, lo: np.float32, hi: np.float32, radar: Radar,
               tf32: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The zoom of one frame's chirps ``[V, ns]`` over ``[lo, hi]`` m: its two strongest peaks' ranges and valid flags."""
    ns, dev = radar.ns, chirps.device
    # a range r is DFT bin r / range_res of ns: the zoom's frequencies in bins, as fractions of ns
    f1, f2 = float(lo) / radar.range_max, float(hi) / radar.range_max
    freqs = f1 + np.arange(ns) * (f2 - f1) / ns
    angle = 2 * np.pi * np.arange(ns)[:, None] * freqs[None, :]  # [j, k] in float64
    factors = torch.tensor(np.exp(-1j * angle), dtype=torch.complex64, device=dev)
    x = _r(chirps, tf32) * _r(_hann(ns, dev), tf32)
    spec = (_r(x, tf32)[:, :, None] * _r(factors, tf32)[None]).sum(dim=1)  # [V, k]
    idx, ok = prominent_peaks(_db(spec.abs().mean(dim=0)), 2)
    idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
    step = np.float32((hi - lo) / np.float32(ns - 1))
    return np.where(ok, lo + idx.astype(np.float32) * step, np.float32(0.0)), ok


def _ground_peak(ranges: np.ndarray, ok: np.ndarray, current: np.float32, p: Dict) -> np.float32:
    """The lowest valid range at or above the minimum altitude and within the search limit of ``current``, else -1."""
    gate = ok & (ranges >= np.float32(p["min_altitude_m"])) & (
        np.abs(ranges - current) <= np.float32(p["altitude_search_limit_m"]))
    return np.float32(ranges[gate].min()) if gate.any() else np.float32(-1.0)


def altitudes(re: torch.Tensor, im: torch.Tensor, radar: Radar, p: Dict, *, tf32: bool = False,
              init: Optional[float] = None) -> Tuple[torch.Tensor, float]:
    """The tracked altitude of every frame ``[T]`` float32 (plus ``range_bias``), and the last one tracked."""
    chirps = loop0_chirps(re, im, radar)
    cand, ok = coarse_candidates(chirps, radar, tf32)
    cand, ok = cand.cpu().numpy(), ok.cpu().numpy()
    zoom = np.float32(p["zoom_search_region_m"])
    top = np.float32(plain_range_bins(radar).max() - np.float32(1e-6))
    current = np.float32(p["min_altitude_m"] if init is None else init)
    out = np.empty(len(cand), np.float32)
    for t in range(len(cand)):
        peak = _ground_peak(cand[t], ok[t], current, p)
        if peak >= 0 and p["precise_est_enabled"]:
            lo = np.float32(max(np.float32(1e-6), np.float32(peak - zoom)))
            hi = np.float32(min(top, np.float32(peak + zoom)))
            refined = _ground_peak(*zoom_peaks(chirps[t], lo, hi, radar, tf32), current, p)
            current = refined if refined > 0 else current
        elif peak >= 0:
            current = peak
        out[t] = current + np.float32(p["range_bias"])
    return torch.as_tensor(out, device=re.device), float(current)


class Cloud(NamedTuple):
    points: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def _os_cfar_rows(mag: torch.Tensor, cfar: Dict) -> torch.Tensor:
    """OS-CFAR along the last axis of ``[B, R, D]``: the detection mask, by sorting each cell's training cells."""
    train, guard = int(cfar["num_train"]), int(cfar["num_guard"])
    edge = train + guard
    n_train = 2 * train
    k = max(1, min(int(float(cfar["rho"]) * n_train), n_train))
    d = mag.shape[-1]
    n_out = d - 2 * edge
    det = torch.zeros_like(mag, dtype=torch.bool)
    if n_out < 1:
        return det
    offsets = [*range(-edge, -guard), *range(guard + 1, edge + 1)]
    cells = torch.stack([mag[..., edge + o:edge + o + n_out] for o in offsets], dim=-1)
    kth = torch.sort(cells, dim=-1).values[..., k - 1]
    det[..., edge:edge + n_out] = mag[..., edge:edge + n_out] > float(cfar["alpha"]) * kth
    return det


def gated_rows(altitude: torch.Tensor, radar: Radar) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first and last range rows ``[T]`` of the ground gate: the bins nearest the altitude and ``min(last bin, altitude / cos 60deg)``."""
    grid = torch.tensor(radar.range_bins(), dtype=torch.float32, device=altitude.device)
    lo = torch.argmin(torch.abs(grid - altitude[:, None]), dim=-1)
    top = torch.minimum(grid.max(), altitude / COS_60)
    return lo, torch.argmin(torch.abs(grid - top[:, None]), dim=-1)


def ground_cloud(re: torch.Tensor, im: torch.Tensor, altitude: torch.Tensor, radar: Radar,
                 p: Dict, *, tf32: bool = False, block: int = 128) -> Cloud:
    """The gated detections of every frame at its altitude, as FLU points in ``max_dets`` slots."""
    dev = re.device
    k_max = int(p["max_dets"])
    w_rng, w_dop = _hann(radar.ns, dev), _hann(radar.loops, dev)
    rows = torch.arange(len(radar.range_bins()), device=dev)
    bins = torch.tensor(angle_bins(int(p["num_angle_bins"])), dtype=torch.float32, device=dev)
    az_ch, el_ch = list(p["az_antennas"]), list(p["el_antennas"])
    nb = int(p["num_angle_bins"])
    parts = []
    for s in range(0, re.shape[0], block):
        e = min(re.shape[0], s + block)
        cube = virtual_cube(torch.complex(re[s:e], im[s:e]), radar.num_rx, radar.cpl)
        x = torch.fft.fft(_r(_r(cube, tf32) * _r(w_rng[:, None], tf32), tf32), dim=-2)
        x = torch.fft.fft(_r(_r(x, tf32) * _r(w_dop, tf32), tf32), dim=-1)
        x = torch.fft.fftshift(x, dim=-1)  # [b, V, ns, loops]
        lo, hi = gated_rows(altitude[s:e], radar)
        gate = (rows >= lo[:, None]) & (rows <= hi[:, None])  # [b, ns]
        det = gate[:, :, None] & _os_cfar_rows(x[:, 0].abs(), p["vel_cfar"])
        b, n_rows, n_cols = det.shape
        n = n_rows * n_cols
        keys = torch.where(det.reshape(b, n), torch.arange(n, device=dev), n)
        first = torch.sort(keys, dim=-1).values[:, :k_max]
        if first.shape[1] < k_max:
            first = torch.nn.functional.pad(first, (0, k_max - first.shape[1]), value=n)
        valid = first < n
        first = torch.where(valid, first, 0)
        r, c = first // n_cols, first % n_cols
        vals = x[torch.arange(b, device=dev)[:, None], :, r, c]  # [b, K, V]

        def angles(channels, shift):
            spec = torch.fft.fft(_r(vals[..., channels], tf32), n=nb, dim=-1)
            if shift:
                spec = torch.fft.fftshift(spec, dim=-1)
            return bins[torch.argmax(spec.real ** 2 + spec.imag ** 2, dim=-1)]

        az = angles(az_ch, bool(p["az_shift"]))
        el = angles(el_ch, bool(p["el_shift"]))
        rng = r.float() * radar.range_res
        vel = c.float() * radar.vel_res - radar.vel_max
        pts = torch.stack([rng * torch.cos(el) * torch.cos(az), rng * torch.cos(el) * torch.sin(az),
                           rng * torch.sin(el), vel], dim=-1)
        parts.append((torch.where(valid[..., None], pts, 0.0), valid, det.reshape(b, n).sum(-1)))
    return Cloud(*(torch.cat(t) for t in zip(*parts)))


class Fit(NamedTuple):
    coef: torch.Tensor  # [..., 3]
    r2: torch.Tensor
    inlier_fraction: torch.Tensor
    kappa: torch.Tensor  # condition number of the winner's inlier directions: inf under D of them


def _lstsq(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Least squares of ``y ~ h c`` over the rows ``w`` keeps (``h [..., N, D]`` float64), by the SVD.

    scipy's ``lstsq`` as sklearn's ``LinearRegression`` calls it: singular
    values at or under ``eps`` times the largest count as zero, so a
    rank-deficient sample gets the least-norm solution.  No rows give 0.
    """
    hw = h * w[..., None]
    u, sv, vh = torch.linalg.svd(hw, full_matrices=False)
    keep = sv > sv[..., :1] * EPS64
    inv = torch.where(keep, 1.0 / torch.where(keep, sv, 1.0), 0.0)
    uty = (u.transpose(-1, -2) @ (y * w)[..., None])[..., 0]
    return (vh.transpose(-1, -2) @ (inv * uty)[..., None])[..., 0]


def _r2(y, pred, w):
    """R^2 of ``pred`` over the rows ``w`` keeps (sklearn's ``score``); 0 where ``y`` is flat there."""
    n = w.sum(-1)
    mean = (y * w).sum(-1) / torch.clamp_min(n, 1.0)
    ss_res = (w * (y - pred) ** 2).sum(-1)
    ss_tot = (w * (y - mean[..., None]) ** 2).sum(-1)
    return torch.where(ss_tot > 0, 1.0 - ss_res / ss_tot, 0.0)


def _fit_block(points, valid, scores, dims, min_samples, threshold, tf32):
    """:func:`ego_velocity` of frames ``[B, K, 4]`` on the host, in float64."""
    p = points[..., :dims].double()
    h = p / torch.clamp_min(torch.sqrt((p * p).sum(-1, keepdim=True)), 1e-300)
    y = -points[..., 3].double()
    if tf32:  # the operands of the fit's products, as a TF32 product would take them
        h, y = round_tf32(h.float()).double(), round_tf32(y.float()).double()
    b, n = valid.shape
    k = min(min_samples, n)
    n_valid = valid.double().sum(-1)
    # each trial's sample: the k valid slots of the highest scores, or every valid slot
    pick = torch.topk(torch.where(valid[:, None, :], scores, float("-inf")), k, dim=-1).indices
    frames = torch.arange(b)[:, None, None]
    coef = _lstsq(h[frames, pick], y[frames, pick], valid[frames, pick].double())  # [B, t, D]
    c = round_tf32(coef.float()).double() if tf32 else coef
    pred = torch.einsum("bnd,btd->btn", h, c)
    inl = (torch.abs(y[:, None] - pred) <= threshold) & valid[:, None, :]
    r2 = _r2(y[:, None], pred, inl.double())
    # the winner: the first maximum of the port's float32 key (see the module docstring)
    trials = torch.arange(scores.shape[1], dtype=torch.float32)
    key = inl.sum(-1).float() * 1e6 + r2.float() + trials * 1e-9
    bw = inl[torch.arange(b), torch.argmax(key, dim=-1)].double()
    final = _lstsq(h, y, bw)
    sv = torch.linalg.svdvals(h * bw[..., None])
    kappa = sv[:, 0] / sv[:, -1]  # inf (or nan, no inliers) where the directions span under D
    c = round_tf32(final.float()).double() if tf32 else final
    m = bw.sum(-1)
    r2 = torch.where(m > 3, _r2(y, torch.einsum("bnd,bd->bn", h, c), bw), 0.0)
    frac = torch.where(n_valid > 0, m / torch.clamp_min(n_valid, 1.0), 0.0)
    ok = n_valid >= min_samples
    coef3 = torch.nn.functional.pad(final, (0, 3 - dims))
    return (torch.where(ok[:, None], coef3, 0.0).float(), torch.where(ok, r2, 0.0).float(),
            torch.where(ok, frac, 0.0).float(),
            torch.where(ok & (sv[:, -1] > 0), kappa, float("inf")).float())


def ego_velocity(points: torch.Tensor, valid: torch.Tensor, scores: torch.Tensor, *, dims: int,
                 min_samples: int, threshold: float, tf32: bool = False,
                 block: int = 128) -> Fit:
    """RANSAC of ``-velocity = (p / |p|) . v`` over each frame's valid points ``[B, K, 4]``, on scores ``[B, trials, K]``.

    On the host in float64, ``block`` frames at a time: every trial's sample
    and the winner's inliers fitted by :func:`_lstsq`, the inlier test and
    R^2 in float64; the results rounded to float32 on the caller's device.
    """
    parts = []
    for s in range(0, points.shape[0], block):
        e = min(points.shape[0], s + block)
        parts.append(_fit_block(points[s:e].cpu(), valid[s:e].cpu(), scores[s:e].cpu(), dims,
                                min_samples, threshold, tf32))
    return Fit(*(torch.cat(t).to(points.device) for t in zip(*parts)))


def carried(fit: Fit, p: Dict, init: Optional[np.ndarray] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each frame's kept estimate ``[T, 3]``, the last proposal at or before it that passed both gates, and that frame (-1: ``init``)."""
    coef = fit.coef.cpu().numpy()
    r2, frac = fit.r2.cpu().numpy(), fit.inlier_fraction.cpu().numpy()
    current = np.zeros(3, np.float32) if init is None else np.asarray(init, np.float32)
    src = -1
    out, source = np.empty_like(coef), np.empty(len(coef), np.int64)
    for t in range(len(coef)):
        if r2[t] >= p["min_r2"] and frac[t] >= p["min_inlier_fraction"]:
            current, src = coef[t], t
        out[t], source[t] = current, src
    dev = fit.coef.device
    return torch.as_tensor(out, device=dev), torch.as_tensor(source, device=dev)


def solve_rounding(a: "Analysis") -> Tuple[torch.Tensor, torch.Tensor]:
    """The error (m/s) a float32 solve of the normal equations may put in each frame's fit, and in its carried estimate: ``[T]`` each.

    float32's unit roundoff times the squared condition number of the inlier
    directions times the fit's largest axis (the normal equations square the
    condition number); a carried estimate has its source frame's, and 0 for
    the start's.  Infinite where the directions span under ``D`` dimensions.
    Measured on the CPU, a float32 program's fits stay within it of this
    float64 reference wherever the condition number is 10 or more.
    """
    kappa = a.kappa.double()
    fit = F32_ROUNDOFF * kappa ** 2 * a.proposed.double().abs().amax(-1)
    fit = torch.where(torch.isfinite(kappa), fit, float("inf"))
    return fit, torch.where(a.source >= 0, fit[a.source.clamp_min(0)], 0.0)


def analysis(re: torch.Tensor, im: torch.Tensor, scores: torch.Tensor, radar: Radar, p: Dict, *,
             dims: int = 3, tf32: bool = False, init_altitude: Optional[float] = None,
             init_velocity: Optional[np.ndarray] = None, block: int = 128) -> Analysis:
    """The analysis of a recording's frames ``[T, rx, ns, chirps]`` in time order, on RANSAC scores ``[T, trials, K]``.

    ``p`` is :func:`settings` of the configuration; ``init_altitude`` and
    ``init_velocity`` start the two carries (``min_altitude_m`` and zeros by
    default).
    """
    alt, _ = altitudes(re, im, radar, p, tf32=tf32, init=init_altitude)
    cloud = ground_cloud(re, im, alt, radar, p, tf32=tf32, block=block)
    fit = ego_velocity(cloud.points, cloud.valid, scores, dims=dims,
                       min_samples=int(p["ransac_min_samples"]),
                       threshold=float(p["ransac_residual_threshold"]), tf32=tf32, block=block)
    velocity, source = carried(fit, p, init_velocity)
    return Analysis(alt, cloud.points, cloud.valid, cloud.count, fit.coef, fit.r2,
                    fit.inlier_fraction, velocity, fit.kappa, source)
