"""Plain building blocks of the reference: DFT matrices, complex products as real ones, peaks, RANSAC.

Plain PyTorch, written for clarity, not speed; it imports nothing of the
program under test.  Every complex product is done as real float32 matrix
products on split planes, so that the precision under test is a property of
the matrix products alone: with ``tf32=True`` each operand is first rounded
to TensorFloat-32 (10 mantissa bits, round to nearest even), which is what
the card's TF32 tensor cores do to float32 inputs.  That is the benchmark's
control, the next precision below the float32 the deployments state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

Planes = Tuple[torch.Tensor, torch.Tensor]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """float32 ``a @ b``; with ``tf32`` the operands are rounded to TF32 first."""
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


def cmatmul(x: Planes, m: Planes, tf32: bool) -> Planes:
    """``(x_re + j x_im) @ (m_re + j m_im)`` from four real products."""
    (xr, xi), (mr, mi) = x, m
    return (matmul(xr, mr, tf32) - matmul(xi, mi, tf32),
            matmul(xr, mi, tf32) + matmul(xi, mr, tf32))


def dft_matrix(n_in: int, n_out: int, *, shift: bool = False,
               window: Optional[np.ndarray] = None, device=None) -> Planes:
    """float32 planes of ``M[j, k] = w[j] exp(-2 pi i j k' / n_out)``, ``k'`` fftshifted if asked.

    Built in float64 and rounded once to float32.
    """
    j = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    if shift:
        k = (k + n_out // 2) % n_out
    ang = 2 * np.pi * j * k / n_out
    w = np.ones(n_in) if window is None else np.asarray(window, np.float64)
    re = np.cos(ang) * w[:, None]
    im = -np.sin(ang) * w[:, None]
    return (torch.tensor(re, dtype=torch.float32, device=device),
            torch.tensor(im, dtype=torch.float32, device=device))


def magnitude(z: Planes) -> torch.Tensor:
    re, im = z
    return torch.sqrt(re * re + im * im)


def virtual_cube(raw: torch.Tensor, num_rx: int, cpl: int) -> torch.Tensor:
    """``[B, rx, ns, loops*cpl] -> [B, cpl*rx, ns, loops]``: chirp ``l*cpl + c`` of rx ``r`` is channel ``c*num_rx + r``."""
    b, _, ns, chirps = raw.shape
    loops = chirps // cpl
    x = raw[:, :num_rx].reshape(b, num_rx, ns, loops, cpl)
    return x.permute(0, 4, 1, 2, 3).reshape(b, cpl * num_rx, ns, loops)


def local_maxima(x: torch.Tensor) -> torch.Tensor:
    """Strict interior local maxima along the last axis; the two ends never are."""
    out = torch.zeros_like(x, dtype=torch.bool)
    out[..., 1:-1] = (x[..., 1:-1] > x[..., :-2]) & (x[..., 1:-1] > x[..., 2:])
    return out


def prominence(x: torch.Tensor) -> torch.Tensor:
    """Topographic prominence of every sample taken as a peak (scipy's, full window).

    The sample less the higher of its two bases; a base is the lowest
    sample between it and the nearest strictly higher sample on that side,
    or the row's end.
    """
    n = x.shape[-1]
    i = torch.arange(n, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    xi, xj = x[..., :, None], x[..., None, :]
    higher = xj > xi
    left_stop = torch.where(higher & (j < i), j, -1).amax(dim=-1, keepdim=True)
    right_stop = torch.where(higher & (j > i), j, n).amin(dim=-1, keepdim=True)
    left = torch.where((j > left_stop) & (j <= i), xj, float("inf")).amin(dim=-1)
    right = torch.where((j >= i) & (j < right_stop), xj, float("inf")).amin(dim=-1)
    return x - torch.maximum(left, right)


class Fit(NamedTuple):
    coef: torch.Tensor  # [...]
    r2: torch.Tensor
    inlier_fraction: torch.Tensor
    ok: torch.Tensor


def _lstsq_1d(h, y, w):
    """Weighted one-coefficient least squares with the relative ridge ``1e-7 * (sum w h^2 + 1e-30)``."""
    a = (h * w * h).sum(-1)
    b = (h * w * y).sum(-1)
    return b / (a + 1e-7 * (a + 1e-30))


def _r2(y, pred, w):
    n = w.sum(-1)
    mean = (y * w).sum(-1) / torch.clamp_min(n, 1.0)
    ss_res = (w * (y - pred) ** 2).sum(-1)
    ss_tot = (w * (y - mean[..., None]) ** 2).sum(-1)
    return torch.where(ss_tot > 0, 1.0 - ss_res / ss_tot, 0.0)


def ransac_1d(h, y, valid, scores, *, min_samples: int, threshold: torch.Tensor) -> Fit:
    """sklearn-style RANSAC of ``y ~ a*h`` over the valid rows, every trial at once.

    ``h``, ``y``, ``valid``: ``[..., N]``; ``scores``: ``[..., T, N]`` Gumbel
    scores, a trial's sample being the valid rows whose score reaches the
    ``k``-th largest, ``k = min(min_samples, N)`` (every valid row when fewer
    are valid).  The winner maximises ``inliers*1e6 + r2 + trial*1e-9`` in
    float32, first maximum on ties; the model is refitted on its inliers.
    """
    n = h.shape[-1]
    k = min(min_samples, n)
    validf = valid.float()
    n_valid = validf.sum(-1)
    s = torch.where(valid[..., None, :], scores, float("-inf"))
    kth = torch.topk(s, k, dim=-1).values[..., k - 1:k]
    w = ((s >= kth) & valid[..., None, :]).float()
    ht, yt = h[..., None, :], y[..., None, :]
    coef = _lstsq_1d(ht, yt, w)
    pred = ht * coef[..., None]
    inl = (torch.abs(yt - pred) <= threshold[..., None, None]) & valid[..., None, :]
    n_in = inl.sum(-1)
    trial_r2 = _r2(yt, pred, inl.float())
    t = torch.arange(scores.shape[-2], dtype=torch.float32, device=h.device)
    best = torch.argmax(n_in.float() * 1e6 + trial_r2 + t * 1e-9, dim=-1)
    bw = torch.gather(inl, -2, best[..., None, None].expand(*best.shape, 1, n))[..., 0, :].float()
    a = _lstsq_1d(h, y, bw)
    m = bw.sum(-1)
    r2 = torch.where(m > 3, _r2(y, h * a[..., None], bw), 0.0)
    frac = torch.where(n_valid > 0, m / torch.clamp_min(n_valid, 1.0), 0.0)
    ok = n_valid >= min_samples
    return Fit(torch.where(ok, a, 0.0), torch.where(ok, r2, 0.0),
               torch.where(ok, frac, 0.0), ok)
