"""The altimeter's frame-to-frame recursion over a recording (JAX: the ``lax.scan`` of ``parallel/ground_pipeline.py``).

The ground scan finds, for every frame and before any recursion, up to three
coarse ground candidates and, for each candidate, up to two zoom-refined
ranges.  What is left is sequential: the tracked altitude gates which
candidate is the ground, and the chosen candidate's refinement (gated by the
same altitude) becomes the next altitude.  Per frame, with ``current`` the
tracked altitude:

1. ``gp``: the lowest valid candidate that is at least ``min_altitude_m``
   and within ``altitude_search_limit_m`` of ``current``, else -1;
2. precise: when ``gp >= 0``, the same rule over the refinements of the
   candidate equal to ``gp``; the new altitude is that value when it is
   positive, else ``current``.  Not precise: ``gp`` when ``gp >= 0``, else
   ``current``;
3. the output is ``new + range_bias``; ``new`` is carried.

Compares, selects and one add: the kernel and the plain version agree bit for
bit.  On the CPU the plain version runs; on a GPU the hand-written kernel
(``csrc/altitude_track.cu``), with no fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import altitude_track as kernel


def find_ground_peak(peak_ranges: torch.Tensor, peak_valid: torch.Tensor,
                     current: torch.Tensor, *, min_altitude_m: float,
                     altitude_search_limit_m: float) -> torch.Tensor:
    """Lowest valid peak of ``[..., K]`` within the tracking gate, else -1: ``[...]``."""
    ok = (peak_valid & (peak_ranges >= min_altitude_m)
          & (torch.abs(peak_ranges - current) <= altitude_search_limit_m))
    gp = torch.where(ok, peak_ranges, float("inf")).amin(dim=-1)
    return torch.where(torch.isfinite(gp), gp, -1.0)


def altitude_track_reference(
    cand: torch.Tensor, valid: torch.Tensor, zbins: Optional[torch.Tensor],
    zvalid: Optional[torch.Tensor], init: torch.Tensor, *, min_altitude_m: float,
    altitude_search_limit_m: float, range_bias: float, precise: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the recursion kernel: a loop of ``T`` steps over tensors.

    Args:
        cand, valid: ``float32`` / ``bool [T, K]`` coarse candidates (ranges in m).
        zbins, zvalid: ``float32`` / ``bool [T, K, Z]`` each candidate's
            refinements; not read (and may be None) when ``precise`` is False.
        init: ``float32`` scalar tensor, the altitude before the first frame.

    Returns ``(alts float32 [T], final float32 [])``: each frame's
    ``new + range_bias``, and the last ``new`` (the carry of a chunked
    recording).
    """
    gate = dict(min_altitude_m=min_altitude_m,
                altitude_search_limit_m=altitude_search_limit_m)
    current = init.reshape(()).to(torch.float32)
    alts = []
    for t in range(cand.shape[0]):
        gp = find_ground_peak(cand[t], valid[t], current, **gate)
        if precise:
            # every candidate equal to gp has the same refinement: take the first
            pick = torch.argmax((valid[t] & (cand[t] == gp)).to(torch.uint8))
            refined = find_ground_peak(zbins[t, pick], zvalid[t, pick], current, **gate)
            new = torch.where(gp >= 0, torch.where(refined > 0, refined, current),
                              current)
        else:
            new = torch.where(gp >= 0, gp, current)
        alts.append(new + range_bias)
        current = new
    if not alts:
        return torch.empty((0,), dtype=torch.float32, device=cand.device), current
    return torch.stack(alts), current


def altitude_track(
    cand: torch.Tensor, valid: torch.Tensor, zbins: Optional[torch.Tensor],
    zvalid: Optional[torch.Tensor], init: torch.Tensor, *, min_altitude_m: float,
    altitude_search_limit_m: float, range_bias: float, precise: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recursion on the inputs' device: the plain version on the CPU, the kernel on a GPU.

    Arguments and result as :func:`altitude_track_reference`.
    """
    kw = dict(min_altitude_m=min_altitude_m,
              altitude_search_limit_m=altitude_search_limit_m,
              range_bias=range_bias, precise=precise)
    if cand.device.type == "cpu":
        return altitude_track_reference(cand, valid, zbins, zvalid, init, **kw)
    if cand.device.type != "cuda":
        raise ValueError(f"no altitude-recursion kernel for device {cand.device}")
    return kernel.altitude_track(cand, valid, zbins, zvalid, init, **kw)
