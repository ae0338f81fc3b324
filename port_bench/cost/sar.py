"""Operations and bytes of one call of the synthetic-aperture depth pipeline, from the configuration alone.

Per frame, with ``ns`` samples, ``E = F*C`` synthetic elements and ``A``
directions:

- operations: the element sum ``[ns, E] @ [E, A]`` in complex arithmetic,
  ``8 ns E A`` (a complex multiply-add as eight real operations), and the
  range DFT ``[ns, ns] @ [ns, A]``, ``8 ns^2 A``.  Evaluating the steering
  phases is not counted, so a design that never stores them is held to the
  same work;
- bytes: the selected samples in once (``ns C`` complex64: each frame's own
  chirps; the aperture's other frames are read again, not counted) and the
  depth head out: an int32 bin and a float32 peak a direction and a
  one-byte gate a frame.

The bound is :func:`port_bench.cost.roofline.bound_seconds` of these.
"""

from __future__ import annotations

from typing import Tuple


def depth_call(batch: int, ns: int, chirps: int, num_frames: int, directions: int
               ) -> Tuple[float, float]:
    """``(ops, bytes)`` of one call over ``batch`` frames."""
    e = num_frames * chirps
    ops = 8.0 * ns * e * directions + 8.0 * ns * ns * directions
    nbytes = 8.0 * ns * chirps + 8.0 * directions + 1.0
    return batch * ops, batch * nbytes
