"""Counting OS-CFAR 2D detection (JAX counterpart: ``ops/cfar.py``).

For detection the rank statistic never has to be computed:

    x > alpha * rank_k(train)   <=>   #{t in train : alpha*t < x} >= k

for ``alpha > 0`` (``ops/cfar.py`` "detection-only" section of the JAX
package), so a cell is detected when at least ``k`` of its training cells,
scaled by ``alpha``, lie strictly below it.  Cells whose window falls off the
map are False.  Geometry follows the reference: window
``2*(num_train + num_guard) + 1`` per axis, the guard box and the cell under
test excluded, rank ``k = clamp(int(rho*N), 1, N)``.

:func:`os_2d_detect` dispatches on the tensor's device only: a CPU tensor
takes the plain version :func:`os_2d_detect_reference`, a CUDA tensor the
hand-written kernel (:mod:`.kernels.os_cfar`) or raises.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import os_cfar as kernel


def train_mask_2d(num_train, num_guard) -> np.ndarray:
    """Boolean ``(win_r, win_d)`` window with the guard box (and CUT) False."""
    win_r = 2 * (num_train[0] + num_guard[0]) + 1
    win_d = 2 * (num_train[1] + num_guard[1]) + 1
    mask = np.ones((win_r, win_d), dtype=bool)
    gr0, gr1 = num_train[0], num_train[0] + 2 * num_guard[0]
    gd0, gd1 = num_train[1], num_train[1] + 2 * num_guard[1]
    mask[gr0 : gr1 + 1, gd0 : gd1 + 1] = False
    return mask


def os_rank(rho: float, n_train: int) -> int:
    """1-based OS rank ``clamp(int(rho*N), 1, N)``, computed on the host."""
    return max(1, min(int(rho * n_train), n_train))


def _geometry(num_train, num_guard, rho: float, alpha: float):
    """Validated ``(num_train, num_guard, training mask, k)``."""
    if not alpha > 0.0:
        raise ValueError(f"OS-CFAR detection needs alpha > 0, got {alpha}")
    tr, td = (int(v) for v in num_train)
    gr, gd = (int(v) for v in num_guard)
    if min(tr, td, gr, gd) < 0:
        raise ValueError(f"negative window size: train {num_train}, guard {num_guard}")
    mask = train_mask_2d((tr, td), (gr, gd))
    return (tr, td), (gr, gd), mask, os_rank(rho, int(mask.sum()))


def os_2d_detect_reference(
    x: torch.Tensor, *, num_train, num_guard, rho: float, alpha: float,
) -> torch.Tensor:
    """Plain PyTorch counting OS-CFAR on ``[..., R, D]``: the slice-stacking form.

    One shifted slice of the map per training offset, compared against the
    cells under test and summed — the arithmetic of the JAX package's XLA
    form (``ops/cfar.py`` ``os_2d_detect``), bit for bit.
    """
    (tr, td), (gr, gd), mask, k = _geometry(num_train, num_guard, rho, alpha)
    er, ed = tr + gr, td + gd
    rows, cols = x.shape[-2:]
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    r_out, d_out = rows - 2 * er, cols - 2 * ed
    if r_out < 1 or d_out < 1:
        return out
    center = x[..., er : er + r_out, ed : ed + d_out]
    count = torch.zeros(center.shape, dtype=torch.int32, device=x.device)
    for i, j in np.argwhere(mask):
        count += alpha * x[..., i : i + r_out, j : j + d_out] < center
    out[..., er : er + r_out, ed : ed + d_out] = count >= k
    return out


def os_2d_detect(
    x: torch.Tensor, *, num_train, num_guard, rho: float, alpha: float,
) -> torch.Tensor:
    """OS-CFAR 2D detection mask: ``float32 [..., R, D] -> bool [..., R, D]``.

    ``k`` is computed here on the host, in Python, never in float32 on the
    device.  Edges, and every cell of a map smaller than one window, are False.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 maps, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"expected [..., R, D] maps, got shape {tuple(x.shape)}")
    train, guard, _, k = _geometry(num_train, num_guard, rho, alpha)
    if x.device.type == "cpu":
        return os_2d_detect_reference(
            x, num_train=train, num_guard=guard, rho=rho, alpha=alpha)
    if x.device.type != "cuda":
        raise ValueError(f"no OS-CFAR kernel for device {x.device}")
    flat = x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()
    det = kernel.os_cfar_2d_detect(flat, num_train=train, num_guard=guard,
                                   k=k, alpha=alpha)
    return det.reshape(x.shape)
