"""CFAR threshold maps (CA / GO / SO / OS, 1D and 2D) and OS-CFAR detection (JAX: ``ops/cfar.py``).

Conventions of the reference, as in the JAX package:

- window ``2*(num_train + num_guard) + 1`` per axis; cells whose window falls
  off the edge get ``+inf`` thresholds (no detections there) and 0 noise; a
  signal shorter than one window is all ``+inf`` / 0;
- CA alpha ``N*(pfa^(-1/N) - 1)`` with N the number of training cells; GO/SO
  use the one-sided N;
- OS-CFAR takes the rank ``k = clamp(int(rho*N), 1, N)`` (1-based, computed on
  the host) and a caller-supplied ``alpha``.

Every function takes leading batch dimensions.  CA, GO and SO are plain
tensor code on both devices: windowed sums over ``unfold`` views, which are
strided views of the signal and never materialise the windows.

The ordered statistic is where the device decides, and only the device: on a
CPU tensor :func:`os_2d` and :func:`os_1d` take the plain versions
(:func:`os_2d_noise_reference`, :func:`kth_smallest_reference`: training
cells, a sort, element ``k-1``); on a CUDA tensor :func:`os_2d` launches the
hand-written noise-map kernel and :func:`os_1d`'s rank selection the
hand-written k-th-smallest kernel (:mod:`.kernels.os_cfar`,
:mod:`.kernels.rank_select`), or they raise.  There is no fallback from one
to the other and no ``method`` selector: anything but ``"auto"`` raises.

For detection alone the rank statistic never has to be computed:

    x > alpha * rank_k(train)   <=>   #{t in train : alpha*t < x} >= k

for ``alpha > 0``, so a cell is detected when at least ``k`` of its training
cells, scaled by ``alpha``, lie strictly below it (:func:`os_2d_detect`, the
same device dispatch with its own kernel, and :func:`os_1d_detect`, plain
tensor code).  Cells whose window falls off the map are False.
"""

from __future__ import annotations

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import os_cfar as kernel
from mmwave_radar_processing_tpu_torch.ops.kernels import rank_select

#: frames whose training cells :func:`os_2d_noise_reference` stacks and sorts at
#: once: the stack is ~220 times the map, 2.3 MB a flagship frame
_SORT_BATCH_CHUNK = 32


def alpha_ca(num_train_cells: int, pfa: float) -> float:
    """CA-CFAR scaling ``N * (pfa^(-1/N) - 1)`` (exponential noise model)."""
    return num_train_cells * (pfa ** (-1.0 / num_train_cells) - 1.0)


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


def _check_alpha(alpha: float) -> None:
    """The counting form of detection holds for a positive scale only."""
    if not alpha > 0.0:
        raise ValueError(f"OS-CFAR detection needs alpha > 0, got {alpha}")


def _geometry(num_train, num_guard, rho: float):
    """Validated ``(num_train, num_guard, training mask, k)``."""
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
    _check_alpha(alpha)
    (tr, td), (gr, gd), mask, k = _geometry(num_train, num_guard, rho)
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
    _check_signal(x, 2)
    _check_alpha(alpha)
    train, guard, _, k = _geometry(num_train, num_guard, rho)
    if x.device.type == "cpu":
        return os_2d_detect_reference(
            x, num_train=train, num_guard=guard, rho=rho, alpha=alpha)
    if x.device.type != "cuda":
        raise ValueError(f"no OS-CFAR kernel for device {x.device}")
    flat = x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()
    det = kernel.os_cfar_2d_detect(flat, num_train=train, num_guard=guard,
                                   k=k, alpha=alpha)
    return det.reshape(x.shape)


# --------------------------------------------------------------------------- #
# threshold maps: shared helpers
# --------------------------------------------------------------------------- #
def _check_signal(x: torch.Tensor, ndim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"expected a float32 signal, got {x.dtype}")
    if x.dim() < ndim:
        raise ValueError(f"expected at least {ndim} dimensions, got shape "
                         f"{tuple(x.shape)}")


def _no_window(x: torch.Tensor):
    """Thresholds and noise of a signal shorter than one window: ``+inf`` and 0."""
    return torch.full_like(x, float("inf")), torch.zeros_like(x)


def _pad_valid(computed: torch.Tensor, edges, fill: float) -> torch.Tensor:
    """Pad the trailing ``len(edges)`` axes by their edge on both sides."""
    pad = [e for edge in reversed(edges) for e in (edge, edge)]
    return torch.nn.functional.pad(computed, pad, value=fill)


def _window_sum_1d(x: torch.Tensor, start: int, size: int, n_out: int) -> torch.Tensor:
    """``out[..., c] = sum(x[..., c+start : c+start+size])`` for ``c < n_out``."""
    return x[..., start : start + n_out + size - 1].unfold(-1, size, 1).sum(-1)


def _window_sum_2d(x: torch.Tensor, start, size, n_out) -> torch.Tensor:
    """The 2D form of :func:`_window_sum_1d` over the last two axes."""
    (r0, d0), (sr, sd), (nr, nd) = start, size, n_out
    block = x[..., r0 : r0 + nr + sr - 1, d0 : d0 + nd + sd - 1]
    return block.unfold(-2, sr, 1).unfold(-2, sd, 1).sum((-2, -1))


def _train_windows_1d(x: torch.Tensor, num_train: int, num_guard: int) -> torch.Tensor:
    """``[..., n_out, 2*num_train]`` training cells: the leading, then the lagging."""
    win = 2 * (num_train + num_guard) + 1
    windows = x.unfold(-1, win, 1)
    return torch.cat([windows[..., :num_train],
                      windows[..., num_train + 2 * num_guard + 1 :]], dim=-1)


# --------------------------------------------------------------------------- #
# 1D threshold maps
# --------------------------------------------------------------------------- #
def _side_sums_1d(x: torch.Tensor, num_train: int, num_guard: int):
    """Sums of the leading and lagging training cells of every valid cell."""
    n_out = x.shape[-1] - 2 * (num_train + num_guard)
    return (_window_sum_1d(x, 0, num_train, n_out),
            _window_sum_1d(x, num_train + 2 * num_guard + 1, num_train, n_out))


def ca_1d(x: torch.Tensor, *, num_train: int, num_guard: int, pfa: float):
    """CA-CFAR ``(thresholds, noise)`` of ``float32 [..., L]``."""
    _check_signal(x, 1)
    edge = num_train + num_guard
    if x.shape[-1] < 2 * edge + 1:
        return _no_window(x)
    left, right = _side_sums_1d(x, num_train, num_guard)
    means = (left + right) / (2 * num_train)
    alpha = alpha_ca(2 * num_train, pfa)
    return (_pad_valid(alpha * means, (edge,), float("inf")),
            _pad_valid(means, (edge,), 0.0))


def go_so_1d(x: torch.Tensor, *, num_train: int, num_guard: int, pfa: float,
             greatest: bool):
    """GO- (``greatest=True``) / SO-CFAR ``(thresholds, noise)`` of ``[..., L]``.

    One-sided training means combined with max (robust at clutter edges) or
    min (robust to closely spaced targets); alpha from the one-sided N.
    """
    _check_signal(x, 1)
    edge = num_train + num_guard
    if x.shape[-1] < 2 * edge + 1:
        return _no_window(x)
    left, right = _side_sums_1d(x, num_train, num_guard)
    combine = torch.maximum if greatest else torch.minimum
    noise = combine(left / num_train, right / num_train)
    alpha = alpha_ca(num_train, pfa)
    return (_pad_valid(alpha * noise, (edge,), float("inf")),
            _pad_valid(noise, (edge,), 0.0))


def kth_smallest_reference(train: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the k-th-smallest kernel: sort the last axis, take ``k-1``."""
    return torch.sort(train, dim=-1).values[..., k - 1]


def _rank_reduce(train: torch.Tensor, k_rank: int, method: str = "auto") -> torch.Tensor:
    """k-th smallest (1-based) along the last axis of ``float32 [..., W]``.

    The device decides: a sort on the CPU, the k-th-smallest kernel on a GPU.
    ``method`` is the JAX package's selector; only ``"auto"`` is accepted.
    """
    if method != "auto":
        raise ValueError(f"method={method!r} is not ported: the device decides "
                         "('auto')")
    if not 1 <= k_rank <= train.shape[-1]:
        raise ValueError(f"rank k={k_rank} outside 1..{train.shape[-1]}")
    if train.device.type == "cpu":
        return kth_smallest_reference(train, k_rank)
    if train.device.type != "cuda":
        raise ValueError(f"no rank-selection kernel for device {train.device}")
    flat = train.reshape(-1, train.shape[-1]).contiguous()
    return rank_select.kth_smallest(flat, k_rank).reshape(train.shape[:-1])


def os_1d(x: torch.Tensor, *, num_train: int, num_guard: int, rho: float,
          alpha: float):
    """OS-CFAR ``(thresholds, noise)`` of ``float32 [..., L]``."""
    _check_signal(x, 1)
    edge = num_train + num_guard
    if x.shape[-1] < 2 * edge + 1:
        return _no_window(x)
    train = _train_windows_1d(x, num_train, num_guard)
    noise = _rank_reduce(train, os_rank(rho, 2 * num_train))
    return (_pad_valid(alpha * noise, (edge,), float("inf")),
            _pad_valid(noise, (edge,), 0.0))


def os_1d_detect(x: torch.Tensor, *, num_train: int, num_guard: int, rho: float,
                 alpha: float) -> torch.Tensor:
    """OS-CFAR 1D detection mask by counting: ``float32 [..., L] -> bool [..., L]``."""
    _check_signal(x, 1)
    _check_alpha(alpha)
    edge = num_train + num_guard
    n_out = x.shape[-1] - 2 * edge
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if n_out < 1:
        return out
    k = os_rank(rho, 2 * num_train)
    center = x[..., edge : edge + n_out]
    count = torch.zeros(center.shape, dtype=torch.int32, device=x.device)
    lagging = num_train + 2 * num_guard + 1
    for j in (*range(num_train), *range(lagging, lagging + num_train)):
        count += alpha * x[..., j : j + n_out] < center
    out[..., edge : edge + n_out] = count >= k
    return out


# --------------------------------------------------------------------------- #
# 2D threshold maps
# --------------------------------------------------------------------------- #
def ca_2d(x: torch.Tensor, *, num_train, num_guard, pfa: float):
    """CA-CFAR ``(thresholds, noise)`` of ``float32 [..., R, D]``.

    The training cells are four rectangles around the guard box (the rows
    above it, the rows below, and the columns left and right of it on its own
    rows); their sums add up with no cancellation, which a window sum less
    the guard-box sum would not give beside a strong cell under test.
    """
    _check_signal(x, 2)
    (tr, td), (gr, gd), mask, _ = _geometry(num_train, num_guard, 1.0)
    er, ed = tr + gr, td + gd
    win_r, win_d = mask.shape
    n_out = (x.shape[-2] - 2 * er, x.shape[-1] - 2 * ed)
    if min(n_out) < 1:
        return _no_window(x)
    blocks = [((0, 0), (tr, win_d)), ((tr + 2 * gr + 1, 0), (tr, win_d)),
              ((tr, 0), (2 * gr + 1, td)), ((tr, td + 2 * gd + 1), (2 * gr + 1, td))]
    total = sum(_window_sum_2d(x, start, size, n_out)
                for start, size in blocks if min(size) > 0)
    n_train = int(mask.sum())
    means = total / n_train
    alpha = alpha_ca(n_train, pfa)
    return (_pad_valid(alpha * means, (er, ed), float("inf")),
            _pad_valid(means, (er, ed), 0.0))


def os_2d_noise_reference(x: torch.Tensor, *, num_train, num_guard, k: int) -> torch.Tensor:
    """Plain version of the noise-map kernel: ``[..., R, D] -> [..., R-2er, D-2ed]``.

    One shifted slice of the map per training offset, stacked on a trailing
    axis and sorted; element ``k-1``.  More than ``_SORT_BATCH_CHUNK`` frames
    are processed in chunks, so that 1024 flagship frames never hold their
    2.4 GB of training cells at once.
    """
    mask = train_mask_2d(num_train, num_guard)
    r_out = x.shape[-2] - mask.shape[0] + 1
    d_out = x.shape[-1] - mask.shape[1] + 1
    flat = x.reshape((-1,) + tuple(x.shape[-2:]))
    out = torch.empty((flat.shape[0], r_out, d_out), dtype=x.dtype, device=x.device)
    for start in range(0, flat.shape[0], _SORT_BATCH_CHUNK):
        chunk = flat[start : start + _SORT_BATCH_CHUNK]
        train = torch.stack([chunk[:, i : i + r_out, j : j + d_out]
                             for i, j in np.argwhere(mask)], dim=-1)
        out[start : start + _SORT_BATCH_CHUNK] = kth_smallest_reference(train, k)
    return out.reshape(tuple(x.shape[:-2]) + (r_out, d_out))


def os_2d(x: torch.Tensor, *, num_train, num_guard, rho: float, alpha: float,
          method: str = "auto"):
    """OS-CFAR ``(thresholds, noise)`` of ``float32 [..., R, D]``.

    The device decides how the rank statistic is found: the plain version on
    the CPU, the noise-map kernel on a GPU.  ``method`` is the JAX package's
    selector; only ``"auto"`` is accepted.
    """
    if method != "auto":
        raise ValueError(f"method={method!r} is not ported: the device decides "
                         "('auto')")
    _check_signal(x, 2)
    (tr, td), (gr, gd), mask, k = _geometry(num_train, num_guard, rho)
    er, ed = tr + gr, td + gd
    if x.shape[-2] < mask.shape[0] or x.shape[-1] < mask.shape[1]:
        return _no_window(x)
    if x.device.type == "cpu":
        noise = os_2d_noise_reference(x, num_train=(tr, td), num_guard=(gr, gd), k=k)
    elif x.device.type == "cuda":
        flat = x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()
        noise = kernel.os_cfar_2d_noise(flat, num_train=(tr, td), num_guard=(gr, gd), k=k)
        noise = noise.reshape(tuple(x.shape[:-2]) + tuple(noise.shape[-2:]))
    else:
        raise ValueError(f"no OS-CFAR kernel for device {x.device}")
    return (_pad_valid(alpha * noise, (er, ed), float("inf")),
            _pad_valid(noise, (er, ed), 0.0))
