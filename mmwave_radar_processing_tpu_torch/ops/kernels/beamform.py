"""Capon and Bartlett power maps: the launches of the hand-written CUDA kernels and their counts.

Replaces three TPU kernels of the JAX package:

- ``capon_power`` replaces ``ops/pallas/capon.py`` ``capon_power_pallas``;
- ``bartlett_power`` replaces ``ops/pallas/capon.py``
  ``bartlett_power_pallas_cov`` and ``ops/pallas/beamform.py``
  ``bartlett_power``, which compute one quantity (``a^H R a = mean_k
  |a^H x_k|^2``) in two layouts; the snapshot blocks ``[N, A, K]`` of the
  second are ``[N, A, 1, K]`` here.

The source is ``csrc/beamform_power.cu`` (one warp per frame and range bin),
compiled by ``nvcc`` at first use (:mod:`._build`).  The plain PyTorch
versions and the dispatch on the device live in :mod:`..beamform`.

``capon_power.launches`` and ``bartlett_power.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: the kernels take 1 to MAX_ANTENNAS antennas
MAX_ANTENNAS = 16


@functools.cache
def _entry(name: str):
    """A C entry point of the library, built at first use, with its argument types."""
    fn = getattr(_build.load("beamform_power"), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, name: str, x: torch.Tensor, steering: torch.Tensor,
            loading: float) -> torch.Tensor:
    """Check what the kernel takes, allocate ``[B, W, M]``, launch ``name`` and count it on ``wrapper``."""
    for t in (x, steering):
        if t.dtype != torch.complex64:
            raise TypeError(f"expected complex64 tensors, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"the beamforming kernels need CUDA tensors, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    if x.dim() != 4 or steering.dim() != 2 or steering.shape[0] != x.shape[1]:
        raise ValueError(f"expected x [B, A, W, K] and steering (A, M), got "
                         f"{tuple(x.shape)} and {tuple(steering.shape)}")
    b, n_ant, w, k = x.shape
    m = steering.shape[1]
    if not 1 <= n_ant <= MAX_ANTENNAS:
        raise ValueError(f"{n_ant} antennas: the kernels take 1 to {MAX_ANTENNAS}")
    if k < 1:
        raise ValueError("no snapshots (K = 0): the covariance is undefined")
    out = torch.empty((b, w, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    launch = _entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # complex64 is read in place as interleaved (re, im) float pairs
        err = launch(x.data_ptr(), steering.data_ptr(), out.data_ptr(),
                     b * w, n_ant, w, k, m, loading, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def capon_power(x: torch.Tensor, steering: torch.Tensor, *,
                loading: float) -> torch.Tensor:
    """Launch the Capon kernel: CUDA complex64 ``[B, A, W, K]``, ``(A, M)`` -> float32 ``[B, W, M]``.

    Raises on anything the kernel does not take: a tensor off the GPU, not
    contiguous, not complex64, or more than ``MAX_ANTENNAS`` antennas.
    """
    return _launch(capon_power, "capon_power", x, steering, float(loading))


def bartlett_power(x: torch.Tensor, steering: torch.Tensor) -> torch.Tensor:
    """Launch the Bartlett kernel: the same inputs and output as :func:`capon_power`."""
    return _launch(bartlett_power, "bartlett_power", x, steering, 0.0)


capon_power.launches = 0
bartlett_power.launches = 0
