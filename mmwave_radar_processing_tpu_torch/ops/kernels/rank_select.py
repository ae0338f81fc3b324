"""k-th smallest along the last axis: the launch of the hand-written CUDA kernel and its count.

Replaces the TPU kernel ``ops/pallas/rank_select.py::kth_smallest`` of the JAX
package.  The kernel source is ``csrc/os_rank_select.cu`` (a bitwise rank
search; 1 to 32 lanes a row, each keeping up to 8 of the row's keys in
registers); it is compiled by ``nvcc`` at first use (:mod:`._build`).  The plain PyTorch version
and the dispatch on the device live in :mod:`..cfar`.

``kth_smallest.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: the grid's x dimension holds at most 2^31 - 1 blocks of 256 threads
_MAX_THREADS = (2**31 - 1) * 256


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("os_rank_select").kth_smallest
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kth_smallest(train: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the kernel: CUDA ``float32 [M, W] -> float32 [M]``, ``k`` 1-based.

    Equal under ``==`` to ``torch.sort(train, -1).values[:, k - 1]``.  Raises
    on anything the kernel does not take, a tensor off the GPU included.
    """
    if train.dtype != torch.float32:
        raise TypeError(f"expected float32 rows, got {train.dtype}")
    if train.dim() != 2:
        raise ValueError(f"expected [M, W] rows, got shape {tuple(train.shape)}")
    if not train.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    if train.device.type != "cuda":
        raise ValueError(f"the rank-selection kernel needs a CUDA tensor, got "
                         f"{train.device}")
    m, w = train.shape
    if not 1 <= int(k) <= w:
        raise ValueError(f"rank k={k} outside 1..{w}")
    if m * 32 > _MAX_THREADS:
        raise ValueError(f"{m} rows exceed one launch's grid")
    out = torch.empty((m,), dtype=torch.float32, device=train.device)
    if m == 0:
        return out
    launch = _kernel()
    with torch.cuda.device(train.device):
        stream = torch.cuda.current_stream(train.device).cuda_stream
        err = launch(train.data_ptr(), out.data_ptr(), m, w, int(k), stream)
    if err != 0:
        raise RuntimeError(f"kth_smallest kernel launch failed: CUDA error {err}")
    kth_smallest.launches += 1
    return out


kth_smallest.launches = 0
