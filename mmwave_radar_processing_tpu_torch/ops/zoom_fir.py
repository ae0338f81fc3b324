"""Zoom FFT by demodulation, FIR low-pass, decimation and a zoom DFT (JAX: ``ops/zoom_fir.py``).

The chirp-z zoom (:mod:`.czt`) needs the whole sample axis on one device.
This is the formulation of the same spectral zoom for a sample axis that is
split over ranks: its only operator that is not local is a short FIR whose
shard boundaries need exactly ``num_taps - 1`` halo samples, the
overlap-save pattern (:mod:`..parallel.overlap_save` is the sharded build,
bit-equal to this composition by construction).

For a band centred on ``f_center`` of width ``fs / decim``:

    1. demodulate:  d[j] = x[j] * exp(-2j*pi*f_center*j/fs)
    2. low-pass FIR (Hamming-windowed sinc, cutoff fs/(2*decim)) on both planes
    3. decimate by ``decim``: rate fs' = fs/decim, length n' = n/decim
    4. zoom DFT to ``m`` bins over ``[f1, f2)`` relative to ``f_center`` at ``fs'``

Output bin ``k`` measures the absolute frequency
``f_center + f1 + k*(f2-f1)/m``.  The signal is ``complex64`` at the
interface; inside, every step works on the real and imaginary planes in the
JAX package's order of operations, one rounding each, so the sharded build
that repeats the steps on its shard gives the same bits.
"""

from __future__ import annotations

import numpy as np
import torch


def lowpass_taps(num_taps: int, cutoff: float, fs: float) -> np.ndarray:
    """Hamming-windowed-sinc low-pass FIR taps with unit DC gain, float32.

    ``cutoff`` is the -6 dB edge in the units of ``fs``.
    """
    if num_taps % 2 == 0:
        raise ValueError("num_taps must be odd (linear phase, integer delay)")
    j = np.arange(num_taps) - (num_taps - 1) / 2
    h = 2 * cutoff / fs * np.sinc(2 * cutoff / fs * j)
    h *= np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def demod_factors(n: int, f_center: float, fs: float):
    """Static ``exp(-2j*pi*f_center*j/fs)`` planes, ``j = 0..n-1``, float32 numpy."""
    ang = -2 * np.pi * f_center * np.arange(n) / fs
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def demodulate(re: torch.Tensor, im: torch.Tensor, dr: torch.Tensor, di: torch.Tensor):
    """``(re + j im) * (dr + j di)`` on planes: ``(re*dr - im*di, re*di + im*dr)``."""
    return re * dr - im * di, re * di + im * dr


def fir_causal(x: torch.Tensor, taps: np.ndarray, dim: int = -1) -> torch.Tensor:
    """Causal FIR ``y[j] = sum_t h[t] x[j-t]`` with zero left padding, on a real tensor.

    A static loop over the taps in a fixed order, so the overlap-save build
    (which runs the same loop on a halo-extended shard) is bit-equal to it.
    """
    x = x.movedim(dim, -1)
    xp = torch.nn.functional.pad(x, (len(taps) - 1, 0))
    return fir_valid(xp, taps).movedim(-1, dim)


def fir_valid(xp: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Valid-mode tap loop on a left-extended signal (last axis).

    ``xp`` carries ``len(taps) - 1`` extension samples on the left: zero
    padding (unsharded) or the left neighbour's halo (overlap-save).
    """
    t_len = len(taps)
    n = xp.shape[-1] - (t_len - 1)
    acc = float(taps[0]) * xp[..., t_len - 1 : t_len - 1 + n]
    for t in range(1, t_len):
        acc = acc + float(taps[t]) * xp[..., t_len - 1 - t : t_len - 1 - t + n]
    return acc


def static_zoom_dft_factors(n: int, m: int, f1: float, f2: float, fs: float, *,
                            delay: float = 0.0, device=None):
    """Static rectangular DTFT factors ``M = C - jS`` of shape ``(n, m)``, built in float64.

    Frequencies ``f_k = f1 + k*(f2-f1)/m`` (endpoint excluded).  ``delay``
    compensates a known group delay in samples (the linear-phase FIR's) by
    evaluating the phases at ``j - delay``.  Unlike
    :func:`.dft.zoom_dft_factors`, whose band edges are per-frame tensors,
    these are host constants; each plane is cast once to float32.
    """
    j = np.arange(n, dtype=np.float64)[:, None] - delay
    k = np.arange(m, dtype=np.float64)[None, :]
    freqs = f1 + k * (f2 - f1) / m
    ang = 2 * np.pi * j * freqs / fs
    return (torch.as_tensor(np.cos(ang).astype(np.float32), device=device),
            torch.as_tensor(np.sin(ang).astype(np.float32), device=device))


def dft_apply(re: torch.Tensor, im: torch.Tensor, factors) -> torch.Tensor:
    """Apply ``(C, S)`` along the last axis as four real matmuls; returns complex64.

    ``re' = re@C + im@S`` and ``im' = im@C - re@S`` (JAX: ``ops/mxu.dft_apply``).
    """
    c, s = factors
    return torch.complex(re @ c + im @ s, im @ c - re @ s)


def zoom_setup(n: int, *, f_center: float, fs: float, decim: int, num_taps: int, m: int,
               f1: float, f2: float, device=None):
    """``(taps, (dr, di), factors)`` of a zoom over ``n`` samples: the constants of both builds."""
    taps = lowpass_taps(num_taps, fs / (2 * decim), fs)
    dr, di = (torch.as_tensor(p, device=device) for p in demod_factors(n, f_center, fs))
    factors = static_zoom_dft_factors(n // decim, m, f1, f2, fs / decim,
                                      delay=(num_taps - 1) / 2 / decim, device=device)
    return taps, (dr, di), factors


def zoom_fft_fir(x: torch.Tensor, *, f_center: float, fs: float, decim: int, num_taps: int,
                 m: int, f1: float, f2: float) -> torch.Tensor:
    """Zoom spectrum of complex64 ``x`` ``[..., n]`` around ``f_center``: complex64 ``[..., m]``.

    ``n`` must be a multiple of ``decim``; ``num_taps`` is odd, and
    ``num_taps - 1`` is the overlap-save halo.  ``m`` bins cover
    ``[f1, f2)`` relative to ``f_center`` at the decimated rate.
    """
    n = x.shape[-1]
    if n % decim != 0:
        raise ValueError(f"n={n} must be a multiple of decim={decim}")
    taps, (dr, di), factors = zoom_setup(n, f_center=f_center, fs=fs, decim=decim,
                                         num_taps=num_taps, m=m, f1=f1, f2=f2, device=x.device)
    d_re, d_im = demodulate(x.real, x.imag, dr, di)
    f_re, f_im = fir_causal(d_re, taps), fir_causal(d_im, taps)
    return dft_apply(f_re[..., ::decim].contiguous(), f_im[..., ::decim].contiguous(), factors)
