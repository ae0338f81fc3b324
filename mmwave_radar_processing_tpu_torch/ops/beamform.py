"""Capon / Bartlett covariance beamforming (JAX: ``ops/beamform.py``).

- **Bartlett**: ``P_m = a_m^H R a_m``, equal to ``mean_k |a_m^H x_k|^2`` over
  the snapshots.
- **Capon / MVDR**: ``P_m = 1 / (a_m^H R^-1 a_m)`` with relative diagonal
  loading; with the Cholesky factor ``R = L L^H`` the denominator is
  ``||L^-1 a_m||^2``.

The JAX package works on split re/im planes, and its Capon solve runs a
Cholesky of the real ``2A x 2A`` embedding, because its TPU runtime had no
complex dtypes.  Here the data is ``complex64`` and the factorisation is the
complex ``A x A`` one, for any ``A``.

:func:`capon_power` and :func:`bartlett_power` take the range-DFT layout
``[B, A, W, K]`` (frames, antennas, range bins, chirps: the output of
``ops.dft.range_dft_channels``) and return ``[B, W, M]`` float32 power.  On
a CPU tensor they run the plain versions below; on a CUDA tensor they launch
the hand-written kernel (``ops/kernels/beamform.py``), or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import beamform as kernel

_TINY = torch.finfo(torch.float32).tiny


# --------------------------------------------------------------------------- #
# steering matrices (host constants)
# --------------------------------------------------------------------------- #
def _complex_f32(ang: np.ndarray) -> torch.Tensor:
    """``exp(j*ang)`` from float64 angles, each plane cast once to float32."""
    return torch.complex(torch.from_numpy(np.cos(ang).astype(np.float32)),
                         torch.from_numpy(np.sin(ang).astype(np.float32)))


def steering_ula(phase_shifts: np.ndarray, n_antennas: int) -> torch.Tensor:
    """Uniform linear array: ``a[n, m] = exp(-j * n * phase_shifts[m])``.

    A target at azimuth ``az`` peaks at the grid entry with
    ``phase_shifts[m] = pi * sin(az)``.  Complex64 ``(n_antennas, M)`` whose
    planes are bit-equal to ``ops/beamform.steering_ula``'s.
    """
    n = np.arange(n_antennas)[:, None]
    return _complex_f32(-n * np.asarray(phase_shifts)[None, :])


def steering_planar(positions_yz: np.ndarray, az_rad: np.ndarray,
                    el_rad: np.ndarray) -> torch.Tensor:
    """Planar array over an az x el grid: complex64 ``(A, n_az * n_el)``, az major.

    ``positions_yz``: ``(A, 2)`` element positions in half-wavelength units.
    Phase ``-pi * (y sin(az) cos(el) + z sin(el))``, built in float64 as the
    JAX package builds it.
    """
    pos = np.asarray(positions_yz, np.float64)
    azg, elg = np.meshgrid(np.asarray(az_rad), np.asarray(el_rad), indexing="ij")
    u_y = (np.sin(azg) * np.cos(elg)).ravel()
    u_z = np.sin(elg).ravel()
    return _complex_f32(-np.pi * (pos[:, 0:1] * u_y[None, :]
                                  + pos[:, 1:2] * u_z[None, :]))


# --------------------------------------------------------------------------- #
# covariance and spectra: the plain versions
# --------------------------------------------------------------------------- #
def spatial_covariance(x: torch.Tensor) -> torch.Tensor:
    """Sample covariance ``R = X X^H / K`` of complex ``[..., A, K]`` snapshots."""
    return torch.matmul(x, x.mH) * (1.0 / x.shape[-1])


def diagonal_load(r: torch.Tensor, loading: float = 1e-3,
                  floor: float = 1e-12) -> torch.Tensor:
    """Relative diagonal loading: ``R + (loading * tr(R)/A + floor) I``."""
    a = r.shape[-1]
    tr = torch.diagonal(r, dim1=-2, dim2=-1).real.sum(-1)
    eye = torch.eye(a, dtype=r.dtype, device=r.device)
    return r + (loading * tr / a + floor)[..., None, None] * eye


def bartlett_from_covariance(r: torch.Tensor, steering: torch.Tensor) -> torch.Tensor:
    """``P_m = Re(a_m^H R a_m)``: ``[..., A, A]`` and ``(A, M)`` -> float32 ``[..., M]``."""
    y = torch.matmul(r, steering)
    return (steering.conj() * y).real.sum(-2)


def bartlett_from_snapshots(x: torch.Tensor, steering: torch.Tensor) -> torch.Tensor:
    """``mean_k |a_m^H x_k|^2``: ``[..., A, K]`` and ``(A, M)`` -> float32 ``[..., M]``."""
    s = torch.matmul(steering.mH, x)  # [..., M, K]
    return (s.real * s.real + s.imag * s.imag).mean(-1)


def cholesky_lower(r: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of Hermitian ``[..., A, A]``, column by column.

    Each diagonal is ``sqrt(max(s, tiny))``, as in the JAX package, so a
    matrix that rounding leaves not quite positive gives a finite factor
    where ``torch.linalg.cholesky`` would raise.
    """
    a = r.shape[-1]
    lower = torch.zeros_like(r)
    for j in range(a):
        s = r[..., j:, j] - torch.matmul(
            lower[..., j:, :j], lower[..., j, :j].conj()[..., None])[..., 0]
        d = torch.sqrt(torch.clamp_min(s[..., 0].real, _TINY))
        lower[..., j, j] = d.to(r.dtype)
        lower[..., j + 1:, j] = s[..., 1:] / d[..., None]
    return lower


def capon_from_covariance(r: torch.Tensor, steering: torch.Tensor, *,
                          loading: float = 1e-3) -> torch.Tensor:
    """``P_m = 1 / max(||L^-1 a_m||^2, tiny)`` of the loaded covariance ``L L^H``.

    ``r``: unloaded ``[..., A, A]``; ``steering``: ``(A, M)``.  Returns
    float32 ``[..., M]``.
    """
    lower = cholesky_lower(diagonal_load(r, loading))
    g = torch.linalg.solve_triangular(
        lower, steering.expand(*lower.shape[:-2], *steering.shape), upper=False)
    denom = (g.real * g.real + g.imag * g.imag).sum(-2)
    return 1.0 / torch.clamp_min(denom, _TINY)


def _snapshots(x: torch.Tensor) -> torch.Tensor:
    """``[B, A, W, K] -> [B, W, A, K]``: the snapshots of each (frame, range bin)."""
    return x.movedim(1, 2)


def capon_power_reference(x: torch.Tensor, steering: torch.Tensor, *,
                          loading: float) -> torch.Tensor:
    """Plain version of :func:`capon_power` (any device)."""
    return capon_from_covariance(spatial_covariance(_snapshots(x)), steering,
                                 loading=loading)


def bartlett_power_reference(x: torch.Tensor, steering: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bartlett_power` (any device): the covariance form."""
    return bartlett_from_covariance(spatial_covariance(_snapshots(x)), steering)


# --------------------------------------------------------------------------- #
# dispatch on the device
# --------------------------------------------------------------------------- #
def _check(x: torch.Tensor, steering: torch.Tensor) -> None:
    if x.dim() != 4 or steering.dim() != 2 or steering.shape[0] != x.shape[1]:
        raise ValueError(f"expected x [B, A, W, K] and steering (A, M), got "
                         f"{tuple(x.shape)} and {tuple(steering.shape)}")
    for t in (x, steering):
        if t.dtype != torch.complex64:
            raise TypeError(f"expected complex64 tensors, got {t.dtype}")
    if x.device != steering.device:
        raise ValueError(f"x on {x.device}, steering on {steering.device}")


def capon_power(x: torch.Tensor, steering: torch.Tensor, *,
                loading: float) -> torch.Tensor:
    """Capon power maps (TPU kernel #7): ``[B, A, W, K]`` -> float32 ``[B, W, M]``."""
    _check(x, steering)
    if x.device.type == "cpu":
        return capon_power_reference(x, steering, loading=loading)
    if x.device.type != "cuda":
        raise ValueError(f"no beamforming kernel for device {x.device}")
    return kernel.capon_power(x, steering, loading=loading)


def bartlett_power(x: torch.Tensor, steering: torch.Tensor) -> torch.Tensor:
    """Bartlett power maps (TPU kernels #8, #9): ``[B, A, W, K]`` -> float32 ``[B, W, M]``.

    #9's snapshot blocks ``[N, A, K]`` are this layout as ``[N, A, 1, K]``.
    """
    _check(x, steering)
    if x.device.type == "cpu":
        return bartlett_power_reference(x, steering)
    if x.device.type != "cuda":
        raise ValueError(f"no beamforming kernel for device {x.device}")
    return kernel.bartlett_power(x, steering)
