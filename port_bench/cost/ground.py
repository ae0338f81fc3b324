"""Operations and bytes of one call of the velocity analysis, from the configuration and the traffic's counts.

The work the result needs, whatever implements it.  Per frame, with ``ns``
samples, ``L`` loops, ``V`` virtual channels, ``U`` channels of the antenna
union with channel 0, ``A_az`` and ``A_el`` antennas of the angle subsets,
``M`` angle bins, ``K`` detection slots, ``n`` detections, ``g`` gated range
rows and ``t`` RANSAC trials of ``s`` samples in ``D`` dimensions, a
transform of ``a`` complex inputs to ``b`` outputs of length ``N`` costs the
lesser of a direct sum, ``8 a b`` real operations, and an FFT, ``5 N log2
N`` (the usual count, for any length):

- operations: the altimeter's coarse range transform of every channel's
  loop-0 chirp, ``V`` transforms of ``ns``; one zoom a frame of those chirps
  (the tracker zooms the one band it picked), ``V`` more, counted at an
  FFT's cost (a lower bound: a chirp-z takes three transforms of twice the
  length); the range transform of the union's channels, ``L U`` of ``ns``;
  channel 0's Doppler transform, ``ns`` of ``L``; the 1D OS-CFAR over the
  gated rows, a scale, a compare and a count per training cell, ``3 * 2
  train`` for each of the ``L - 2 (train + guard)`` cells a row tests; per
  detection the Doppler bin of each union channel, ``U`` direct sums of
  ``L`` to 1, and the two angle transforms, ``A_az`` and ``A_el`` inputs to
  ``M``; the RANSAC: per trial the sample's normal equations, ``2 (D^2 + D)
  s``, and the residuals of every detection, ``2 D n``, then the refit over
  the winner's inliers, at most ``2 (D^2 + D) n``;
- bytes: the planes read once (``rx ns L cpl`` complex64), the scores
  (``t K`` float32), and the outputs written once: points, valid flags,
  count, altitude, the fit and the carried estimate (``17 K + 40``).

``n`` and ``g`` depend on the flight: the caller gives their means over the
frames.  The bound is :func:`port_bench.cost.roofline.bound_seconds` of these.
"""

from __future__ import annotations

import math
from typing import Tuple


def transform(inputs: int, outputs: int, length: int) -> float:
    """Real operations of one complex transform: the lesser of a direct sum and an FFT of ``length``."""
    return min(8.0 * inputs * outputs, 5.0 * length * math.log2(length))


def ground_call(frames: int, *, ns: int, loops: int, rx: int, cpl: int, union: int,
                az_antennas: int, el_antennas: int, angle_bins: int, capacity: int,
                num_train: int, num_guard: int, trials: int, samples: int, dims: int,
                dets_per_frame: float, gated_rows_per_frame: float) -> Tuple[float, float]:
    """``(ops, bytes)`` of one call over ``frames`` frames."""
    v = rx * cpl
    tested = max(loops - 2 * (num_train + num_guard), 0)
    n = dets_per_frame
    fit = 2.0 * (dims * dims + dims)
    rng = transform(ns, ns, ns)
    ops = (2 * v * rng + loops * union * rng + ns * transform(loops, loops, loops)
           + 3.0 * 2 * num_train * tested * gated_rows_per_frame
           + n * (union * transform(loops, 1, loops)
                  + transform(az_antennas, angle_bins, angle_bins)
                  + transform(el_antennas, angle_bins, angle_bins))
           + trials * (fit * samples + 2.0 * dims * n) + fit * n)
    nbytes = 8.0 * rx * ns * loops * cpl + 4.0 * trials * capacity + 17.0 * capacity + 40.0
    return frames * ops, frames * nbytes
