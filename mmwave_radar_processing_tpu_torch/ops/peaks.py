"""Peak picking with prominences along the last axis (JAX: ``ops/peaks.py``).

What the velocity path and the altimeter use: strict local maxima, the
highest local maximum whose topographic prominence (scipy's definition, full
window) reaches a floor, and the strongest such peaks within a band below the
highest.  Every step is a comparison, a sort or a min/max, so the
indices and the ``found`` flags equal the JAX package's exactly, ties
included.  The JAX functions work on one row under ``vmap``; here every
function takes ``[..., N]`` and works on all leading rows at once.
"""

from __future__ import annotations

from typing import Tuple

import torch


def local_maxima(x: torch.Tensor) -> torch.Tensor:
    """Strict interior local maxima of ``[..., N]``: ``x[i-1] < x[i] > x[i+1]``.

    Both ends compare against ``+inf``, so an end sample is never a peak.
    """
    inf = torch.full_like(x[..., :1], float("inf"))
    left = torch.cat([inf, x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], inf], dim=-1)
    return (x > left) & (x > right)


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


def best_prominent_peak(
    x: torch.Tensor, min_prominence: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest local maximum of each row with prominence ``>= min_prominence``.

    ``[..., N] -> (index int64 [...], found bool [...])``.  Ties in value go
    to the lowest index (the first maximum, as ``argmax`` over the dense
    masked row takes it); a row with no such peak gives index 0 and
    ``found`` False.
    """
    n = x.shape[-1]
    cand_vals, cand_idx = _candidate_peaks(x)
    prom = _prominences_at(x, cand_vals, cand_idx)
    passing = torch.isfinite(cand_vals) & (prom >= min_prominence)
    vmax = torch.where(passing, cand_vals, float("-inf")).amax(dim=-1, keepdim=True)
    best = torch.where(passing & (cand_vals == vmax), cand_idx, n).amin(dim=-1)
    return torch.where(best < n, best, 0), passing.any(dim=-1)


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
