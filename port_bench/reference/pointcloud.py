"""Plain reference of the batched point cloud: raw ADC frames -> the first detections as FLU points.

The upstream RadVel point-cloud chain, written out directly:

1. the virtual array (TDM chirps to 12 channels);
2. a Hann-windowed range DFT and a Hann-windowed, fftshifted Doppler DFT of
   every channel;
3. OS-CFAR on channel 0's magnitude: a cell is detected when it exceeds
   ``alpha`` times the ``k``-th smallest of its training cells,
   ``k = clamp(int(rho*N), 1, N)``; cells whose window leaves the map are not;
4. the first ``max_dets`` detections in row-major order;
5. azimuth and elevation of each from the argmax of a zero-padded angle DFT
   over its antenna subset, and the FLU point ``(x, y, z, velocity)``.

Frames are processed in blocks, so the training cells of a block fit.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from port_bench.reference import dsp
from port_bench.reference.radar import Radar, angle_bins


class Cloud(NamedTuple):
    points: torch.Tensor  # float32 [B, K, 4]
    valid: torch.Tensor  # bool [B, K]
    count: torch.Tensor  # int64 [B]
    rows: torch.Tensor  # int64 [B, K] range bins
    cols: torch.Tensor  # int64 [B, K] Doppler bins


def range_doppler(raw_re, raw_im, radar: Radar, tf32: bool):
    """Range-Doppler planes of every virtual channel: ``[B, 12, ns, loops]`` each."""
    dev = raw_re.device
    x = (dsp.virtual_cube(raw_re, radar.num_rx, radar.cpl),
         dsp.virtual_cube(raw_im, radar.num_rx, radar.cpl))
    rng = dsp.dft_matrix(radar.ns, radar.ns, window=np.hanning(radar.ns), device=dev)
    dop = dsp.dft_matrix(radar.loops, radar.loops, shift=True,
                         window=np.hanning(radar.loops), device=dev)
    # range along samples: R = M^T x
    rt = (rng[0].T.contiguous(), rng[1].T.contiguous())
    r = dsp.cmatmul(rt, x, tf32)
    return dsp.cmatmul(r, dop, tf32)


def os_cfar(mag: torch.Tensor, *, num_train, num_guard, rho: float, alpha: float):
    """Detection mask of ``[B, R, D]`` by the ordered statistic of the training cells."""
    tr, td = num_train
    gr, gd = num_guard
    er, ed = tr + gr, td + gd
    win = np.ones((2 * er + 1, 2 * ed + 1), bool)
    win[tr:tr + 2 * gr + 1, td:td + 2 * gd + 1] = False
    n_train = int(win.sum())
    k = max(1, min(int(rho * n_train), n_train))
    b, rows, cols = mag.shape
    ro, co = rows - 2 * er, cols - 2 * ed
    det = torch.zeros_like(mag, dtype=torch.bool)
    if ro < 1 or co < 1:
        return det
    train = torch.stack([mag[:, i:i + ro, j:j + co] for i, j in np.argwhere(win)], dim=-1)
    noise = torch.kthvalue(train, k, dim=-1).values
    det[:, er:er + ro, ed:ed + co] = mag[:, er:er + ro, ed:ed + co] > alpha * noise
    return det


def first_detections(det: torch.Tensor, capacity: int):
    """Row-major ``(rows, cols, valid, count)`` of the first ``capacity`` True cells."""
    b, rows, cols = det.shape
    n = rows * cols
    flat = det.reshape(b, n)
    keys = torch.where(flat, torch.arange(n, device=det.device), n)
    first = torch.sort(keys, dim=-1).values[:, :capacity]
    valid = first < n
    first = torch.where(valid, first, 0)
    return first // cols, first % cols, valid, valid.sum(-1)


def point_cloud_block(raw_re, raw_im, radar: Radar, p: Dict, tf32: bool) -> Cloud:
    re, im = range_doppler(raw_re, raw_im, radar, tf32)
    mag = dsp.magnitude((re[:, 0], im[:, 0]))
    det = os_cfar(mag, num_train=p["cfar"]["num_train"], num_guard=p["cfar"]["num_guard"],
                  rho=p["cfar"]["rho"], alpha=p["cfar"]["alpha"])
    rows, cols, valid, count = first_detections(det, p["max_dets"])
    b, k = rows.shape
    bi = torch.arange(b, device=rows.device)[:, None]
    val_re = re[bi, :, rows, cols]  # [B, K, 12]
    val_im = im[bi, :, rows, cols]
    nb = p["num_angle_bins"]
    bins = torch.tensor(angle_bins(nb), dtype=torch.float32, device=rows.device)

    def angles(antennas, shift):
        m = dsp.dft_matrix(len(antennas), nb, shift=shift, device=rows.device)
        idx = list(antennas)
        spec = dsp.cmatmul((val_re[..., idx], val_im[..., idx]), m, tf32)
        power = spec[0] * spec[0] + spec[1] * spec[1]
        return bins[torch.argmax(power, dim=-1)]

    az = angles(p["az_antennas"], True)
    el = angles(p["el_antennas"], False)
    rng = rows.float() * radar.range_res
    vel = cols.float() * radar.vel_res - radar.vel_max
    pts = torch.stack([rng * torch.cos(el) * torch.cos(az), rng * torch.cos(el) * torch.sin(az),
                       rng * torch.sin(el), vel], dim=-1)
    pts = torch.where(valid[..., None], pts, 0.0)
    return Cloud(pts, valid, count, rows, cols)


def point_cloud(raw_re, raw_im, radar: Radar, p: Dict, *, tf32: bool = False,
                block: int = 32) -> Cloud:
    """The reference point cloud of ``[B, rx, ns, chirps]`` float32 planes, ``block`` frames at a time."""
    parts = [point_cloud_block(raw_re[i:i + block], raw_im[i:i + block], radar, p, tf32)
             for i in range(0, raw_re.shape[0], block)]
    return Cloud(*(torch.cat(t) for t in zip(*parts)))
