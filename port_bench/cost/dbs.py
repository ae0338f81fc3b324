"""Operations and bytes of one call of the DBS pipeline, from the configuration alone.

The work the result needs, whatever implements it.  Per frame, with ``ns``
samples, ``L`` loops, ``A`` selected antennas, ``M`` coarse angle bins and
``D`` DBS angles (a complex multiply-add as eight real operations):

- operations: the range DFT of the selected channels, ``8 ns^2 L A``; each
  picked value as one point of the 2D (Doppler, angle) DFT, ``8 L A`` per
  range bin and DBS angle, ``8 ns D L A``; the plain map of one chirp, its
  range DFT ``8 ns^2 A`` and its angle DFT ``8 ns A M``.  Both branches are
  counted for every frame: the gate chooses per frame, after both;
- bytes: the selected channels' samples in once (``A ns L`` complex64), the
  velocity (three float32) and the map out (``ns D`` float32).

The bound is :func:`port_bench.cost.roofline.bound_seconds` of these.
"""

from __future__ import annotations

from typing import Tuple


def dbs_call(batch: int, ns: int, loops: int, antennas: int, angle_bins: int, dbs_bins: int
             ) -> Tuple[float, float]:
    """``(ops, bytes)`` of one call over ``batch`` frames."""
    ops = (8.0 * ns * ns * loops * antennas + 8.0 * ns * dbs_bins * loops * antennas
           + 8.0 * ns * ns * antennas + 8.0 * ns * antennas * angle_bins)
    nbytes = 8.0 * antennas * ns * loops + 12.0 + 4.0 * ns * dbs_bins
    return batch * ops, batch * nbytes
