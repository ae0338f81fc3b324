"""Chirp-z transform (zoom FFT) by Bluestein's algorithm (JAX: ``ops/czt.py``).

A CZT is two FFTs and pointwise complex multiplies.  Semantics match
``scipy.signal.ZoomFFT(n, [f1, f2], fs=fs)`` with the scipy defaults ``m=n``,
``endpoint=False``:

    scale = (f2 - f1) / fs
    y[k]  = sum_j x[j] * exp(-2j*pi*(f1/fs + scale*k/m)*j),   k = 0..m-1

i.e. ``m`` frequency samples from ``f1`` (inclusive) stepping ``(f2-f1)/m``.
The FFTs are ``torch.fft`` on either device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def czt_factors(n: int, m: int, f1: float, f2: float, fs: float):
    """Static Bluestein factors of a zoom FFT, built in float64 on the host.

    Returns ``(awk2, fwk2, wk2_m, nfft)`` as numpy complex64 constants,
    bit-equal to the JAX package's:

    - ``awk2``: (n,) input chirp factors ``exp(-2j*pi*f1*j/fs) * w(j)``
    - ``fwk2``: (nfft,) FFT of the reciprocal chirp
    - ``wk2_m``: (m,) output chirp factors
    """
    k = np.arange(max(m, n), dtype=np.float64)
    scale = (f2 - f1) / fs  # endpoint=False convention
    wk2 = np.exp(-1j * np.pi * scale * k**2 / m)
    ak = np.exp(-2j * np.pi * f1 / fs * k[:n])
    awk2 = ak * wk2[:n]
    nfft = _next_pow2(n + m - 1)
    fwk2 = np.fft.fft(1.0 / np.concatenate([wk2[n - 1:0:-1], wk2[:m]]), nfft)
    return (
        awk2.astype(np.complex64),
        fwk2.astype(np.complex64),
        wk2[:m].astype(np.complex64),
        nfft,
    )


def _bluestein(x: torch.Tensor, awk2, fwk2, wk2_m, *, n: int, m: int, nfft: int,
               axis: int) -> torch.Tensor:
    if x.shape[axis] != n:
        raise ValueError(f"axis {axis} has {x.shape[axis]} samples, expected n={n}")
    y = torch.movedim(x, axis, -1).to(torch.complex64) * awk2
    y = torch.fft.ifft(torch.fft.fft(y, n=nfft, dim=-1) * fwk2, dim=-1)
    y = y[..., n - 1 : n + m - 1] * wk2_m
    return torch.movedim(y, -1, axis)


def zoom_fft(x: torch.Tensor, *, n: int, m: Optional[int] = None, f1: float,
             f2: float, fs: float = 2.0, axis: int = -1,
             factors=None) -> torch.Tensor:
    """Zoom FFT of ``x`` along ``axis`` over the static band ``[f1, f2)``.

    Equivalent to ``scipy.signal.ZoomFFT(n, [f1, f2], fs=fs)(x, axis)``; ``n``
    must equal ``x.shape[axis]``.  ``factors`` takes ready
    ``(awk2, fwk2, wk2_m)`` tensors on ``x``'s device in place of the ones
    :func:`czt_factors` would build.
    """
    if m is None:
        m = n
    nfft = _next_pow2(n + m - 1)
    if factors is None:
        factors = tuple(torch.from_numpy(f).to(x.device) for f in
                        czt_factors(n, m, float(f1), float(f2), float(fs))[:3])
    return _bluestein(x, *factors, n=n, m=m, nfft=nfft, axis=axis)


def zoom_fft_dynamic(x: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, *,
                     n: int, m: Optional[int] = None, fs: float = 2.0,
                     axis: int = -1) -> torch.Tensor:
    """Zoom FFT whose band edges ``f1``/``f2`` are scalar tensors on ``x``'s device.

    The same transform as :func:`zoom_fft`, with the chirp factors built in
    float32 on the device, in the JAX package's order of operations, so a
    band that follows the data (the altimeter's window around the tracked
    ground peak) costs no host round trip.
    """
    if m is None:
        m = n
    f1 = torch.as_tensor(f1, dtype=torch.float32, device=x.device)
    f2 = torch.as_tensor(f2, dtype=torch.float32, device=x.device)
    k = torch.arange(max(m, n), dtype=torch.float32, device=x.device)
    scale = (f2 - f1) / fs
    ang = (-np.float32(math.pi) * scale) * k**2 / m
    wk2 = torch.complex(torch.cos(ang), torch.sin(ang))
    ang = (np.float32(-2.0 * math.pi) * f1) / fs * k[:n]
    awk2 = torch.complex(torch.cos(ang), torch.sin(ang)) * wk2[:n]
    nfft = _next_pow2(n + m - 1)
    fwk2 = torch.fft.fft(1.0 / torch.cat([wk2[1:n].flip(0), wk2[:m]]), n=nfft)
    return _bluestein(x, awk2, fwk2, wk2[:m], n=n, m=m, nfft=nfft, axis=axis)
