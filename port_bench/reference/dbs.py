"""The plain reference of Doppler beam sharpening (DBS) over a batch of frames.

Plain PyTorch in float32, independent of the program under test; it
transforms with FFTs (``torch.fft``), not with DFT matrices.  It follows
upstream ``processors/range_angle_resp_dbs_enhanced.py:137-263``.  Per raw
frame ``[rx, ns, chirps]`` and velocity ``v`` (the axes of the DBS
pipeline's velocities: ``x`` along boresight, ``y`` along the azimuth row):

- the virtual channels ``rx_antennas``, taken from each chirp's TX slot
  (:func:`port_bench.reference.dsp.virtual_cube`);
- the sharpened map: Hann windows over the range samples, the Doppler loops
  and the selected antennas; an FFT along each axis, the antennas
  zero-padded to ``M = num_angle_bins``, fftshifts on Doppler and angle.
  For each of ``D = num_dbs_angle_bins`` angles ``theta``, spaced evenly from
  the first coarse angle to the last, the magnitude at the nearest coarse
  angle and at the Doppler bin nearest ``-(v_x cos theta + v_y sin theta)``
  (the first bin on a tie);
- the fallback map, upstream's ``process_no_dbs``: chirp ``chirp_idx`` of the
  whole virtual array windowed with a Hann window over all its channels,
  then the selected channels, the Hann-windowed range FFT and the
  zero-padded, shifted angle FFT without an angle window; its magnitude.
  Upstream returns it at the ``M`` coarse angles, ``(ns, M)``.  Here it is
  resampled to the nearest coarse angle of each DBS angle, ``(ns, D)``, as
  the batched pipeline returns it: the one departure from upstream;
- the gate: a frame is sharpened where ``sqrt(v_x^2 + v_y^2)`` reaches
  ``min_x_y_vel_dbs``, else it takes the fallback map.

With ``tf32=True`` every product's operands are first rounded to TF32
(:func:`port_bench.reference.dsp.round_tf32`): the data and the windows of
each window product, the inputs of each FFT, the velocity and the
directions of the projection, and the gate's squares.  That is the control.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from port_bench.reference.dsp import round_tf32, virtual_cube
from port_bench.reference.radar import Radar, angle_bins


class Maps(NamedTuple):
    sharpened: torch.Tensor  # [B, ns, D] float32
    plain: torch.Tensor  # [B, ns, D] float32: the fallback map
    fast: torch.Tensor  # [B] bool: the frame is sharpened
    bins: torch.Tensor  # [B, D] int64: the Doppler bin of each DBS angle

    def map(self) -> torch.Tensor:
        """Each frame's map on its side of the gate."""
        return torch.where(self.fast[:, None, None], self.sharpened, self.plain)


def dbs_angles(p: dict) -> Tuple[np.ndarray, np.ndarray]:
    """float64 DBS angles ``[D]`` and the index of each one's nearest coarse angle."""
    coarse = angle_bins(int(p["num_angle_bins"]))
    dbs = np.linspace(coarse[0], coarse[-1], int(p["num_dbs_angle_bins"]))
    return dbs, np.argmin(np.abs(coarse[None, :] - dbs[:, None]), axis=1)


def _r(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``x`` (real or complex float32), rounded to TF32 where asked."""
    if not tf32:
        return x
    if x.is_complex():
        return torch.complex(round_tf32(x.real), round_tf32(x.imag))
    return round_tf32(x)


def _window(x: torch.Tensor, w: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _r(x, tf32) * _r(w, tf32)


def _fft(x: torch.Tensor, dim: int, tf32: bool, n=None, shift: bool = False) -> torch.Tensor:
    out = torch.fft.fft(_r(x, tf32), n=n, dim=dim)
    return torch.fft.fftshift(out, dim=dim) if shift else out


def doppler_bins(vels: torch.Tensor, radar: Radar, p: dict, tf32: bool = False) -> torch.Tensor:
    """int64 ``[B, D]``: per frame and DBS angle the Doppler bin nearest ``-(r_hat . v_xy)``."""
    dbs, _ = dbs_angles(p)
    dev = vels.device
    cos = torch.tensor(np.cos(dbs), dtype=torch.float32, device=dev)
    sin = torch.tensor(np.sin(dbs), dtype=torch.float32, device=dev)
    vx, vy = _r(vels[:, :1], tf32), _r(vels[:, 1:2], tf32)
    expected = -(vx * _r(cos, tf32) + vy * _r(sin, tf32))  # [B, D]
    vel_bins = torch.tensor(radar.vel_bins(), dtype=torch.float32, device=dev)
    return torch.argmin(torch.abs(vel_bins - expected[..., None]), dim=-1)


def gate(vels: torch.Tensor, p: dict, tf32: bool = False) -> torch.Tensor:
    """bool ``[B]``: ``sqrt(v_x^2 + v_y^2) >= min_x_y_vel_dbs``."""
    vx, vy = _r(vels[:, 0], tf32), _r(vels[:, 1], tf32)
    return torch.sqrt(vx * vx + vy * vy) >= float(p["min_x_y_vel_dbs"])


def maps(re: torch.Tensor, im: torch.Tensor, vels: torch.Tensor, radar: Radar, p: dict, *,
         tf32: bool = False, block: int = 128) -> Maps:
    """Both maps, the gate and the Doppler bins of frames ``re``/``im`` ``[B, rx, ns, chirps]`` at velocities ``vels [B, 3]``."""
    dev = re.device
    m = int(p["num_angle_bins"])
    chans = torch.as_tensor(list(p["rx_antennas"]), device=dev)
    a = len(chans)
    hann = lambda n: torch.tensor(np.hanning(n), dtype=torch.float32, device=dev)  # noqa: E731
    w_rng, w_dop, w_ant, w_all = hann(radar.ns), hann(radar.loops), hann(a), hann(radar.n_virtual)
    _, near = dbs_angles(p)
    near = torch.as_tensor(near, device=dev)
    vels = vels.to(torch.float32)
    bins = doppler_bins(vels, radar, p, tf32)
    out = []
    for s in range(0, re.shape[0], block):
        e = min(re.shape[0], s + block)
        virt = virtual_cube(torch.complex(re[s:e], im[s:e]), radar.num_rx, radar.cpl)
        sub = virt[:, chans]  # [b, A, ns, L]
        x = _fft(_window(sub, w_rng[:, None], tf32), -2, tf32)
        x = _fft(_window(x, w_dop, tf32), -1, tf32, shift=True)
        cube = _fft(_window(x, w_ant[:, None, None], tf32), 1, tf32, n=m, shift=True)
        frame = torch.arange(e - s, device=dev)[:, None]
        picked = cube[frame, near[None, :], :, bins[s:e]]  # [b, D, ns]
        sharpened = torch.abs(picked).transpose(1, 2)

        chirp = _window(virt[..., int(p["chirp_idx"])], w_all[:, None], tf32)[:, chans]
        ra = _fft(_window(chirp, w_rng, tf32), -1, tf32)  # [b, A, ns]
        ra = _fft(ra, 1, tf32, n=m, shift=True)  # [b, M, ns]
        plain = torch.abs(ra)[:, near].transpose(1, 2)
        out.append((sharpened.contiguous(), plain.contiguous()))
    sharpened, plain = (torch.cat(parts) for parts in zip(*out))
    return Maps(sharpened, plain, gate(vels, p, tf32), bins)
