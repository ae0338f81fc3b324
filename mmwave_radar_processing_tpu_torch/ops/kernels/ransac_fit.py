"""The RANSAC fit: the launch of the hand-written CUDA kernel and its count.

Replaces no TPU kernel: the JAX package's ``ops/ransac.ransac_linear`` is
plain ``jnp``.  The kernel source is ``csrc/ransac_fit.cu``: a block a fit
and a warp a trial; the fit's valid rows of ``h``, ``y`` and the scores are
compacted into shared memory, each warp takes its sample's k-th score by
rounds of warp maxima, solves its ridged normal equations in registers and
counts its inliers; the block picks the winner and warp 0 refits.  It is
compiled by ``nvcc`` at first use (:mod:`._build`).  The plain PyTorch
version and the dispatch on the device live in :mod:`..ransac`.

``ransac_fit.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: the most trials a fit may have: a warp each (``kMaxTrials`` in the source)
MAX_TRIALS = 32
#: the most features ``D`` (``kMaxFeatures``)
MAX_FEATURES = 3
#: the most rows ``N`` a fit may have (``kMaxRows``)
MAX_ROWS = 2048
#: a block's dynamic shared memory on Hopper (``kMaxSharedBytes``)
MAX_SHARED_BYTES = 227 * 1024


def shared_bytes(n: int, d: int, trials: int) -> int:
    """A block's shared memory, as the source lays it out: 4-byte words."""
    chunks = (n + 31) // 32
    return 4 * (2 * chunks + (d + 1 + trials) * n + trials * chunks + trials)


def takes(n: int, d: int, trials: int) -> bool:
    """Whether the kernel fits ``N`` rows of ``D`` features over ``trials`` trials."""
    return (1 <= n <= MAX_ROWS and 1 <= d <= MAX_FEATURES and 1 <= trials <= MAX_TRIALS
            and shared_bytes(n, d, trials) <= MAX_SHARED_BYTES)


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("ransac_fit").ransac_fit
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_float,  # h, y, valid, scores, thr, thr_value
                   i64, i32, i32, i32, i32, i32,  # fits, n, d, trials, k, min_samples
                   ptr, ptr, ptr, ptr, ptr, ptr]  # coef, r2, fraction, mask, ok, stream
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, device, shape):
    if t.dtype != dtype:
        raise TypeError(f"the RANSAC kernel takes {dtype} {name}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected {name} of shape {list(shape)}, got {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"the RANSAC kernel needs a contiguous {name} tensor")
    if t.device != device:
        raise ValueError(f"h on {device}, {name} on {t.device}")


def ransac_fit(
    h: torch.Tensor, y: torch.Tensor, valid: torch.Tensor, scores: torch.Tensor,
    threshold: Union[float, torch.Tensor], *, min_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(coef [..., D], r2 [...], inlier_fraction [...], inlier_mask [..., N], ok [...])``.

    ``h`` float32 ``[..., N, D]``, ``y`` float32 and ``valid`` bool
    ``[..., N]``, ``scores`` float32 ``[..., T, N]``, all contiguous on one
    CUDA device; ``threshold`` a float or a float32 tensor broadcastable to
    the leading shape ``[...]``.  The fit of
    ``ops.ransac.ransac_linear_reference``, the sums in another order.
    Raises on anything the kernel does not take, the arguments checked
    before the device: shapes outside :func:`takes`, ``min_samples < 1``,
    another dtype, shapes that do not match, a tensor not contiguous, or
    tensors off the GPU.
    """
    if h.dim() < 2:
        raise ValueError(f"expected h [..., N, D], got shape {tuple(h.shape)}")
    n, d = h.shape[-2:]
    lead = tuple(h.shape[:-2])
    trials = scores.shape[-2] if scores.dim() >= 2 else 0
    if not takes(n, d, trials):
        raise ValueError(f"the RANSAC kernel takes 1 to {MAX_ROWS} rows, 1 to {MAX_FEATURES} "
                         f"features and 1 to {MAX_TRIALS} trials within {MAX_SHARED_BYTES} "
                         f"bytes of shared memory, got N = {n}, D = {d}, T = {trials}")
    if min_samples < 1:
        raise ValueError(f"the RANSAC kernel needs min_samples >= 1, got {min_samples}")
    device = h.device
    _check("h", h, torch.float32, device, (*lead, n, d))
    _check("y", y, torch.float32, device, (*lead, n))
    _check("valid", valid, torch.bool, device, (*lead, n))
    _check("scores", scores, torch.float32, device, (*lead, trials, n))
    if isinstance(threshold, torch.Tensor):
        if threshold.dim() > len(lead) or any(
                t not in (1, m) for t, m in zip(reversed(threshold.shape), reversed(lead))):
            raise ValueError(f"expected a threshold broadcastable to {list(lead)}, got "
                             f"{list(threshold.shape)}")
        threshold = torch.broadcast_to(threshold, lead).contiguous()
        _check("threshold", threshold, torch.float32, device, lead)
        thr_ptr, thr_value = threshold.data_ptr(), np.float32(0.0)
    else:
        thr_ptr, thr_value = None, np.float32(threshold)
    if device.type != "cuda":
        raise ValueError(f"the RANSAC kernel needs a CUDA tensor, got {device}")
    coef = torch.empty((*lead, d), dtype=torch.float32, device=device)
    r2 = torch.empty(lead, dtype=torch.float32, device=device)
    fraction = torch.empty(lead, dtype=torch.float32, device=device)
    mask = torch.empty((*lead, n), dtype=torch.bool, device=device)
    ok = torch.empty(lead, dtype=torch.bool, device=device)
    fits = r2.numel()
    if fits == 0:
        return coef, r2, fraction, mask, ok
    launch = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(h.data_ptr(), y.data_ptr(), valid.data_ptr(), scores.data_ptr(), thr_ptr,
                     thr_value, fits, n, d, trials, min(min_samples, n), min_samples,
                     coef.data_ptr(), r2.data_ptr(), fraction.data_ptr(), mask.data_ptr(),
                     ok.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ransac_fit kernel launch failed at {fits} fits, N={n}, D={d}, "
                           f"T={trials}: CUDA error {err}")
    ransac_fit.launches += 1
    return coef, r2, fraction, mask, ok


ransac_fit.launches = 0
