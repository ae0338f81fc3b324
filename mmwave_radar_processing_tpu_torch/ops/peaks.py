"""Peak picking with prominences along the last axis (JAX: ``ops/peaks.py``).

What the velocity path and the altimeter use: strict local maxima, the
highest local maximum whose topographic prominence (scipy's definition, full
window) reaches a floor, and the strongest such peaks within a band below the
highest; and for the object API the dense prominence of every sample,
``find_peaks`` and ``best_peak``.  Every step is a comparison, a sort or a
min/max, so the indices and the ``found`` flags equal the JAX package's
exactly, ties included.  The JAX functions work on one row under ``vmap``; here every
function takes ``[..., N]`` and works on all leading rows at once.

:func:`best_prominent_peak`, the velocity path's peak picker, dispatches on
the device only: a CPU tensor takes the plain version
:func:`best_prominent_peak_reference`, a CUDA tensor the hand-written kernel
(:mod:`.kernels.peaks`) or raises.  There is no fallback from one to the
other; the two agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import peaks as kernel
from mmwave_radar_processing_tpu_torch.ops.masked import mask_to_indices


def local_maxima(x: torch.Tensor) -> torch.Tensor:
    """Strict interior local maxima of ``[..., N]``: ``x[i-1] < x[i] > x[i+1]``.

    Both ends compare against ``+inf``, so an end sample is never a peak.
    """
    inf = torch.full_like(x[..., :1], float("inf"))
    left = torch.cat([inf, x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], inf], dim=-1)
    return (x > left) & (x > right)


def prominences(x: torch.Tensor, peak_mask: torch.Tensor) -> torch.Tensor:
    """Topographic prominence of every sample of ``[..., N]`` taken as a peak.

    scipy's ``peak_prominences`` with a full window: ``x[i]`` less the higher
    of its two bases, each the minimum of ``x`` between ``i`` and the nearest
    strictly higher sample on that side (or the row's end).  Dense pairwise
    ``[..., N, N]`` masks, as in the JAX package; entries where
    ``peak_mask`` is False are 0.
    """
    n = x.shape[-1]
    i = torch.arange(n, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    xi = x[..., :, None]
    xj = x[..., None, :]
    higher = xj > xi
    nhl = torch.where(higher & (j < i), j, -1).amax(dim=-1, keepdim=True)
    left_min = torch.where((j > nhl) & (j <= i), xj, float("inf")).amin(dim=-1)
    nhr = torch.where(higher & (j > i), j, n).amin(dim=-1, keepdim=True)
    right_min = torch.where((j >= i) & (j < nhr), xj, float("inf")).amin(dim=-1)
    prom = x - torch.maximum(left_min, right_min)
    return torch.where(peak_mask, prom, 0.0)


def find_peaks(x: torch.Tensor, capacity: int,
               min_prominence: Optional[float] = None):
    """Strict local maxima of ``[..., N]``, optionally of prominence ``>= min_prominence``.

    Returns ``(indices, valid, count)`` of :func:`..masked.mask_to_indices`:
    ascending index order, as ``scipy.signal.find_peaks`` lists them.
    """
    mask = local_maxima(x)
    if min_prominence is not None:
        mask = mask & (prominences(x, mask) >= min_prominence)
    return mask_to_indices(mask, capacity)


def best_peak(x: torch.Tensor, capacity: int = 32):
    """Highest local maximum of each row: ``(index int64, value, found bool)``, each ``[...]``.

    The reference's ``peaks[argmax(x[peaks])]``; ties go to the lowest index
    and a row with no local maximum gives index 0 and ``found`` False.
    ``capacity`` is the JAX signature's and is not used.
    """
    mask = local_maxima(x)
    idx = torch.argmax(torch.where(mask, x, float("-inf")), dim=-1)
    value = torch.gather(x, -1, idx[..., None])[..., 0]
    return idx, value, mask.any(dim=-1)


def _candidate_peaks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``(N+1)//2`` local maxima by value: an exact bound on their number.

    Strict local maxima are never adjacent, so a row holds at most
    ``ceil((N-1)/2)`` of them and the candidates contain every peak.
    Returns ``(values, indices)``, values descending and ties by ascending
    index (the order of ``lax.top_k``, which a stable descending sort gives);
    slots that are not peaks carry ``-inf``.
    """
    m = (x.shape[-1] + 1) // 2
    masked = torch.where(local_maxima(x), x, float("-inf"))
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return vals[..., :m], idx[..., :m]


def _prominences_at(x: torch.Tensor, cand_vals: torch.Tensor,
                    cand_idx: torch.Tensor) -> torch.Tensor:
    """Topographic prominence of each candidate: ``[..., M]`` from ``[..., N]``.

    The candidate minus the higher of its two bases; a base is the minimum of
    ``x`` between the candidate and the nearest strictly higher sample on
    that side (or the row's end).  Pairwise ``[..., M, N]`` masks, as in the
    JAX package.
    """
    n = x.shape[-1]
    j = torch.arange(n, device=x.device, dtype=torch.int32)
    i = cand_idx.to(torch.int32)[..., :, None]
    xi = cand_vals[..., :, None]
    xj = x[..., None, :]
    higher = xj > xi
    nhl = torch.where(higher & (j < i), j, -1).amax(dim=-1, keepdim=True)
    in_left = (j > nhl) & (j <= i)
    left_min = torch.where(in_left, xj, float("inf")).amin(dim=-1)
    nhr = torch.where(higher & (j > i), j, n).amin(dim=-1, keepdim=True)
    in_right = (j >= i) & (j < nhr)
    right_min = torch.where(in_right, xj, float("inf")).amin(dim=-1)
    return cand_vals - torch.maximum(left_min, right_min)


def best_prominent_peak_reference(
    x: torch.Tensor, min_prominence: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch :func:`best_prominent_peak`: the JAX package's candidate masks.

    The top ``(N+1)//2`` local maxima (:func:`_candidate_peaks`), their
    prominences from pairwise masks (:func:`_prominences_at`), then the
    highest that passes.
    """
    n = x.shape[-1]
    cand_vals, cand_idx = _candidate_peaks(x)
    prom = _prominences_at(x, cand_vals, cand_idx)
    passing = torch.isfinite(cand_vals) & (prom >= min_prominence)
    vmax = torch.where(passing, cand_vals, float("-inf")).amax(dim=-1, keepdim=True)
    best = torch.where(passing & (cand_vals == vmax), cand_idx, n).amin(dim=-1)
    return torch.where(best < n, best, 0), passing.any(dim=-1)


def best_prominent_peak(
    x: torch.Tensor, min_prominence: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest local maximum of each row with prominence ``>= min_prominence``.

    ``[..., N] -> (index int64 [...], found bool [...])``.  Ties in value go
    to the lowest index (the first maximum, as ``argmax`` over the dense
    masked row takes it); a row with no such peak gives index 0 and
    ``found`` False.  A peak passes only if its value is finite; a NaN
    between a peak and either of its bases makes its prominence NaN, and it
    fails.  On a CUDA tensor the kernel takes float32, contiguous rows of 1
    to ``kernels.peaks.MAX_N`` samples and raises on anything else.
    """
    if x.device.type == "cpu":
        return best_prominent_peak_reference(x, min_prominence)
    if x.device.type != "cuda":
        raise ValueError(f"no peak kernel for device {x.device}")
    return kernel.prominent_peak(x, min_prominence)


def top_peaks_within_threshold(
    x_db: torch.Tensor, max_peaks: int, min_prominence: float = 6.0,
    threshold_db: float = 20.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Strongest prominent peaks within ``threshold_db`` of the highest one.

    Local maxima of prominence ``>= min_prominence``, less those more than
    ``threshold_db`` below the strongest; the ``max_peaks`` largest, by
    descending value (ties by ascending index, as ``lax.top_k`` orders them).
    ``[..., N] -> (indices int64, values, valid bool)``, each
    ``[..., max_peaks]``; slots past the last peak hold index 0, value 0 and
    ``valid`` False.
    """
    cand_vals, cand_idx = _candidate_peaks(x_db)
    prom = _prominences_at(x_db, cand_vals, cand_idx)
    passing = torch.isfinite(cand_vals) & (prom >= min_prominence)
    max_val = torch.where(passing, cand_vals, float("-inf")).amax(dim=-1, keepdim=True)
    passing = passing & (cand_vals >= max_val - threshold_db)
    vals = torch.where(passing, cand_vals, float("-inf"))
    k = min(max_peaks, vals.shape[-1])
    top_vals, sel = torch.sort(vals, dim=-1, descending=True, stable=True)
    top_vals, sel = top_vals[..., :k], sel[..., :k]
    valid = torch.isfinite(top_vals)
    top_idx = torch.where(valid, torch.gather(cand_idx, -1, sel), 0)
    if k < max_peaks:  # a row shorter than the requested number of peaks
        pad = (0, max_peaks - k)
        top_vals = torch.nn.functional.pad(top_vals, pad, value=float("-inf"))
        top_idx = torch.nn.functional.pad(top_idx, pad)
        valid = torch.nn.functional.pad(valid, pad)
    return top_idx, torch.where(valid, top_vals, 0.0), valid
