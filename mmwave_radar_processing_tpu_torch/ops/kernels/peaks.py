"""The velocity peak picker: the launch of the hand-written CUDA kernel and its count.

Replaces no TPU kernel: the JAX package's ``ops/peaks.best_prominent_peak``
is plain ``jnp`` (pairwise masks under ``vmap``).  The kernel source is
``csrc/prominent_peak.cu``: one warp a row, the block's rows staged in
shared memory, a walk outwards from each local maximum to its bases and a
shuffle reduction to the winner.  It is compiled by ``nvcc`` at first use
(:mod:`._build`).  The plain PyTorch version and the dispatch on the device
live in :mod:`..peaks`.

``prominent_peak.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: the widest row the kernel takes (``kMaxN`` in the source)
MAX_N = 1024


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("prominent_peak").prominent_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def prominent_peak(x: torch.Tensor, min_prominence: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: CUDA float32 ``[..., N]`` -> ``(index int64 [...], found bool [...])``.

    Equal bit for bit to ``ops.peaks.best_prominent_peak_reference``.
    Raises on anything the kernel does not take: another dtype, a tensor off
    the GPU or not contiguous, ``N`` outside ``1..MAX_N``.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"the peak kernel takes float32, got {x.dtype}")
    if x.dim() < 1 or not 1 <= x.shape[-1] <= MAX_N:
        raise ValueError(f"the peak kernel takes rows of 1 to {MAX_N} samples, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the peak kernel needs a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"the peak kernel needs a CUDA tensor, got {x.device}")
    n = x.shape[-1]
    index = torch.empty(x.shape[:-1], dtype=torch.int64, device=x.device)
    found = torch.empty(x.shape[:-1], dtype=torch.bool, device=x.device)
    rows = index.numel()
    if rows == 0:
        return index, found
    launch = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), rows, n, np.float32(min_prominence), index.data_ptr(),
                     found.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"prominent_peak kernel launch failed at {rows} rows of {n}: "
                           f"CUDA error {err}")
    prominent_peak.launches += 1
    return index, found


prominent_peak.launches = 0
