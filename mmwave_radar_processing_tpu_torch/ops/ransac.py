"""Fixed-trial RANSAC for small no-intercept linear models (JAX: ``ops/ransac.py``).

All ``max_trials`` hypotheses are fitted at once, each a closed-form
least-squares solve on a random sample of ``min_samples`` valid rows; the
winner has the most inliers, ties decided by the trial's R^2, and the final
model is refitted on the winner's inliers (sklearn's ``RANSACRegressor``
criterion).  Everything is batched over the leading dimensions: one call
fits every frame and every model of a batch.

Two versions of one function: :func:`ransac_linear_reference`, batched
PyTorch operations over ``[..., trials, N]`` (the CPU's path, held to the
JAX package by the tests), and the hand-written kernel
``csrc/ransac_fit.cu`` (:mod:`.kernels.ransac_fit`), a block a fit and a
warp a trial with every intermediate on chip.  :func:`ransac_linear` runs
the reference on CPU tensors and launches the kernel on CUDA tensors; it
raises on what the kernel does not take and on any other device.

Sampling is Gumbel top-k as a threshold mask: a row is in a trial's sample
when its score is at least the ``k``-th largest score among the valid rows.
The scores are an argument, so a test can hand in the JAX package's own
draws (its PRNG cannot be reproduced here); without them they are drawn from
a seeded ``torch.Generator``.

Two behaviours of the reference are kept on purpose:

- with fewer valid rows than ``k = min(min_samples, N)`` the ``k``-th
  largest score is ``-inf``, so every valid row is sampled;
- the winner is the first maximum of the float32 expression
  ``n_inliers * 1e6 + r2 + trial * 1e-9``, evaluated in that order.  From
  17 inliers on, the spacing of float32 values there is 2 or more, so the
  R^2 and trial terms are mostly rounded away.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import ransac_fit as fit_kernel


class RansacResult(NamedTuple):
    coef: torch.Tensor  # float32 [..., D]
    r2: torch.Tensor  # float32 [...]: R^2 on the winning inlier set
    inlier_fraction: torch.Tensor  # float32 [...]: inliers / valid rows
    inlier_mask: torch.Tensor  # bool [..., N]
    ok: torch.Tensor  # bool [...]: at least min_samples valid rows


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel scores ``-log(-log(u))``, ``u`` uniform in ``[tiny, 1)``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _masked_lstsq(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted normal equations ``argmin ||w*(y - H c)||`` with a relative ridge.

    ``h [..., N, D]``, ``y`` and ``w [..., N]`` -> ``[..., D]``.  The ridge
    ``1e-7 * (trace(A)/D + 1e-30)`` keeps rank-deficient samples finite; for
    ``D = 1`` the solve is one division.
    """
    hw = h * w[..., None]
    a = hw.transpose(-1, -2) @ h  # [..., D, D]
    b = (hw * y[..., None]).sum(dim=-2)  # [..., D]
    d = a.shape[-1]
    trace = torch.diagonal(a, dim1=-2, dim2=-1).sum(dim=-1)
    ridge = 1e-7 * (trace / d + 1e-30)
    if d == 1:
        return b / (a[..., 0, :] + ridge[..., None])
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    # solve_ex: the ridge keeps the system regular, so no error check (a host sync) is needed
    return torch.linalg.solve_ex(a + ridge[..., None, None] * eye, b)[0]


def _masked_r2(y: torch.Tensor, pred: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """R^2 over the rows selected by ``w`` (sklearn ``score``); 0 if they are flat."""
    n = w.sum(dim=-1)
    mean_y = (y * w).sum(dim=-1) / torch.clamp_min(n, 1.0)
    ss_res = (w * (y - pred) ** 2).sum(dim=-1)
    ss_tot = (w * (y - mean_y[..., None]) ** 2).sum(dim=-1)
    return torch.where(ss_tot > 0, 1.0 - ss_res / ss_tot, 0.0)


def _check_scores(scores: torch.Tensor, lead, max_trials: int, n: int) -> None:
    if tuple(scores.shape) != (*lead, max_trials, n):
        raise ValueError(f"scores of shape {tuple(scores.shape)}, expected "
                         f"{(*lead, max_trials, n)}")


def ransac_linear(
    h: torch.Tensor,
    y: torch.Tensor,
    valid: torch.Tensor,
    *,
    min_samples: int = 10,
    residual_threshold=0.15,
    max_trials: int = 20,
    scores: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> RansacResult:
    """Robust fit ``y ~ H @ coef`` over the valid rows, for every leading index.

    On CPU tensors it is :func:`ransac_linear_reference`.  On CUDA tensors
    the whole fit is one launch of ``csrc/ransac_fit.cu``, which takes
    ``D <= 3``, ``max_trials <= 32``, the rows within a block's shared memory
    (:func:`.kernels.ransac_fit.takes`: at most ``MAX_ROWS``), bool ``valid``,
    float32 ``scores`` and ``min_samples >= 1``, and raises on anything else.

    Args:
        h: ``[..., N, D]`` design matrices.
        y: ``[..., N]`` targets.
        valid: ``[..., N]`` bool; invalid rows take no part.
        residual_threshold: inlier bound on ``|y - H coef|``, a float or a
            tensor broadcastable to the leading shape ``[...]``.
        scores: ``[..., max_trials, N]`` Gumbel scores of the trials'
            samples.  When None they are drawn with ``generator``, which is
            then required (on ``h``'s device).
    """
    n = h.shape[-2]
    lead = h.shape[:-2]
    if scores is None:
        if generator is None:
            raise ValueError("pass the Gumbel scores or a generator to draw them")
        scores = gumbel((*lead, max_trials, n), generator, device=h.device)
    _check_scores(scores, lead, max_trials, n)
    if h.device.type == "cpu":
        return ransac_linear_reference(h, y, valid, min_samples=min_samples,
                                       residual_threshold=residual_threshold,
                                       max_trials=max_trials, scores=scores)
    if h.device.type != "cuda":
        raise ValueError(f"no RANSAC kernel for device {h.device}")
    thr = residual_threshold
    if isinstance(thr, torch.Tensor):
        thr = thr.to(device=h.device, dtype=torch.float32)
    return RansacResult(*fit_kernel.ransac_fit(
        h.to(torch.float32).contiguous(), y.to(torch.float32).contiguous(),
        valid.contiguous(), scores.contiguous(), thr, min_samples=min_samples))


def ransac_linear_reference(
    h: torch.Tensor,
    y: torch.Tensor,
    valid: torch.Tensor,
    *,
    min_samples: int = 10,
    residual_threshold=0.15,
    max_trials: int = 20,
    scores: torch.Tensor,
) -> RansacResult:
    """:func:`ransac_linear` as batched PyTorch operations, every trial at once, on any device."""
    n, d = h.shape[-2:]
    lead = h.shape[:-2]
    h = h.to(torch.float32)
    y = y.to(torch.float32)
    validf = valid.to(torch.float32)
    n_valid = validf.sum(dim=-1)
    k = min(min_samples, n)
    _check_scores(scores, lead, max_trials, n)
    if isinstance(residual_threshold, torch.Tensor):
        thr = residual_threshold.to(device=h.device, dtype=torch.float32)
    else:  # filled in on the device: no copy from the host
        thr = torch.full((), float(residual_threshold), dtype=torch.float32, device=h.device)

    # the trials ride a new axis before the rows
    h_t, y_t, valid_t = h[..., None, :, :], y[..., None, :], valid[..., None, :]
    s = torch.where(valid_t, scores, float("-inf"))
    kth = torch.topk(s, k, dim=-1).values[..., k - 1 : k]
    w = ((s >= kth) & valid_t).to(torch.float32)
    coef = _masked_lstsq(h_t, y_t.expand(w.shape), w)  # [..., T, D]
    pred = (h_t @ coef[..., None])[..., 0]  # [..., T, N]
    inliers = (torch.abs(y_t - pred) <= thr[..., None, None]) & valid_t
    n_ins = inliers.sum(dim=-1)
    trial_r2 = _masked_r2(y_t, pred, inliers.to(torch.float32))

    # sklearn's winner, as the reference orders it (see the module docstring)
    trial = torch.arange(max_trials, dtype=torch.float32, device=h.device)
    order = n_ins.to(torch.float32) * 1e6 + trial_r2 + trial * 1e-9
    best = torch.argmax(order, dim=-1)
    best_inliers = torch.gather(
        inliers, -2, best[..., None, None].expand(*lead, 1, n))[..., 0, :]
    best_w = best_inliers.to(torch.float32)

    final_coef = _masked_lstsq(h, y, best_w)
    n_in = best_w.sum(dim=-1)
    r2 = torch.where(n_in > 3, _masked_r2(y, (h @ final_coef[..., None])[..., 0],
                                          best_w), 0.0)
    fraction = torch.where(n_valid > 0, n_in / torch.clamp_min(n_valid, 1.0), 0.0)
    ok = n_valid >= min_samples
    return RansacResult(
        coef=torch.where(ok[..., None], final_coef, 0.0),
        r2=torch.where(ok, r2, 0.0),
        inlier_fraction=torch.where(ok, fraction, 0.0),
        inlier_mask=best_inliers & ok[..., None],
        ok=ok,
    )
