"""OS-CFAR 2D: the launches of the two hand-written CUDA kernels and their counts.

:func:`os_cfar_2d_detect` replaces the TPU kernel
``ops/pallas/os_cfar.py::os_cfar_2d_detect_fused`` of the JAX package (source
``csrc/os_cfar_detect.cu``: one thread block per frame, the map in shared
memory), and :func:`os_cfar_2d_noise` replaces
``ops/pallas/os_cfar.py::os_cfar_2d_noise_fused`` (source
``csrc/os_rank_select.cu``: the map in shared memory, a bitwise rank search
per cell).  Both are compiled by ``nvcc`` at first use (:mod:`._build`).  The
window geometry, the rank ``k``, the plain PyTorch versions and the dispatch
on the device live in :mod:`..cfar`.

``os_cfar_2d_detect.launches`` and ``os_cfar_2d_noise.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: the kernel keeps one map in shared memory: at most 227 KB a block on Hopper
MAX_MAP_CELLS = 232448 // 4


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("os_cfar_detect").os_cfar_2d_detect
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_maps(x: torch.Tensor) -> None:
    """Raise on anything the kernels do not take, a tensor off the GPU included."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 maps, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"expected [B, R, D] maps, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"the OS-CFAR kernel needs a CUDA tensor, got {x.device}")
    rows, cols = x.shape[1:]
    if rows * cols > MAX_MAP_CELLS:
        raise ValueError(f"a {rows}x{cols} map does not fit in shared memory "
                         f"(at most {MAX_MAP_CELLS} cells)")


def os_cfar_2d_detect(
    x: torch.Tensor, *, num_train, num_guard, k: int, alpha: float,
) -> torch.Tensor:
    """Launch the kernel: CUDA ``float32 [B, R, D] -> bool [B, R, D]``.

    ``k`` is the 1-based rank, already computed on the host.  Raises on
    anything the kernel does not take, a tensor off the GPU included.
    """
    _check_maps(x)
    b, rows, cols = x.shape
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    if b == 0:
        return out
    (tr, td), (gr, gd) = num_train, num_guard
    launch = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), b, rows, cols, tr, td, gr,
                     gd, int(k), float(alpha), stream)
    if err != 0:
        raise RuntimeError(f"os_cfar_2d_detect kernel launch failed: CUDA error {err}")
    os_cfar_2d_detect.launches += 1
    return out


os_cfar_2d_detect.launches = 0


#: blocks in flight that fill the card: two for each of an H100's 132 SMs
_TARGET_BLOCKS = 264
_THREADS = 256  # kThreads of csrc/os_rank_select.cu


@functools.cache
def _noise_kernel():
    """The noise map's C entry point, built at first use, with its argument types declared."""
    fn = _build.load("os_rank_select").os_cfar_2d_noise
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def os_cfar_2d_noise(
    x: torch.Tensor, *, num_train, num_guard, k: int,
) -> torch.Tensor:
    """Launch the kernel: CUDA ``float32 [B, R, D] -> float32 [B, R-2er, D-2ed]``.

    The rank-``k`` (1-based, computed on the host) smallest training cell of
    every core cell; ``er``/``ed`` are ``num_train + num_guard`` per axis.
    Raises on anything the kernel does not take: a tensor off the GPU, a map
    smaller than one window (the caller answers that without a launch), ``k``
    outside ``1..n_train``.
    """
    _check_maps(x)
    (tr, td), (gr, gd) = num_train, num_guard
    if min(tr, td, gr, gd) < 0:
        raise ValueError(f"negative window size: train {num_train}, guard {num_guard}")
    b, rows, cols = x.shape
    win_r, win_d = 2 * (tr + gr) + 1, 2 * (td + gd) + 1
    r_out, d_out = rows - win_r + 1, cols - win_d + 1
    if r_out < 1 or d_out < 1:
        raise ValueError(f"a {rows}x{cols} map is smaller than the {win_r}x{win_d} "
                         "window")
    n_train = win_r * win_d - (2 * gr + 1) * (2 * gd + 1)
    if not 1 <= int(k) <= n_train:
        raise ValueError(f"rank k={k} outside 1..{n_train}")
    out = torch.empty((b, r_out, d_out), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    # a small batch is split over more blocks, each with its own copy of the map
    splits = max(1, min(-(-_TARGET_BLOCKS // b), -(-r_out * d_out // _THREADS)))
    launch = _noise_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), b, rows, cols, tr, td, gr, gd,
                     int(k), splits, stream)
    if err != 0:
        raise RuntimeError(f"os_cfar_2d_noise kernel launch failed: CUDA error {err}")
    os_cfar_2d_noise.launches += 1
    return out


os_cfar_2d_noise.launches = 0
