"""OS-CFAR 2D detection: the launch of the hand-written CUDA kernel and its count.

Replaces the TPU kernel ``ops/pallas/os_cfar.py::os_cfar_2d_detect_fused`` of
the JAX package.  The kernel source is ``csrc/os_cfar_detect.cu`` (one thread
block per frame, the map in shared memory); it is compiled by ``nvcc`` at
first use (:mod:`._build`).  The window geometry, the rank ``k``, the plain
PyTorch version and the dispatch on the device live in :mod:`..cfar`.

``os_cfar_2d_detect.launches`` counts kernel launches.
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


def os_cfar_2d_detect(
    x: torch.Tensor, *, num_train, num_guard, k: int, alpha: float,
) -> torch.Tensor:
    """Launch the kernel: CUDA ``float32 [B, R, D] -> bool [B, R, D]``.

    ``k`` is the 1-based rank, already computed on the host.  Raises on
    anything the kernel does not take, a tensor off the GPU included.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 maps, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"expected [B, R, D] maps, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"the OS-CFAR kernel needs a CUDA tensor, got {x.device}")
    b, rows, cols = x.shape
    if rows * cols > MAX_MAP_CELLS:
        raise ValueError(f"a {rows}x{cols} map does not fit in shared memory "
                         f"(at most {MAX_MAP_CELLS} cells)")
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
