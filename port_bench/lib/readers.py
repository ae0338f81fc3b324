"""Shared arithmetic of the per-layer readers: which kernels a name pattern takes, and per-frame scaling.

A reader that finds nothing to read returns None, and the harness leaves its
metric out of the result line; it never reads a share as 0.
"""

from __future__ import annotations

import math
import re
from typing import Optional

#: cuBLAS and CUTLASS matrix-product kernels, with cuBLAS's split-K reduction
GEMM = re.compile(r"gemm|gemv|splitKreduce", re.IGNORECASE)
#: the program's hand-written kernels (``csrc/*.cu``)
HAND_WRITTEN = re.compile(r"os_cfar_2d_|doppler_az_responses_kernel|beamform_kernel|"
                          r"altitude_track_kernel|kth_search_kernel|kth_network_kernel|"
                          r"kth_warp_sort_kernel|prominent_peak_kernel")


def per_kframe_ms(seconds: float, frames: int) -> Optional[float]:
    """Milliseconds per 1024 frames, or None where no frame or no time was traced."""
    if frames <= 0 or seconds <= 0:
        return None
    return seconds * 1e3 * 1024 / frames


def idle_pct(ctx) -> Optional[float]:
    """The device's idle share of the traced window, in %; None where the trace saw no device."""
    t = ctx["trace"]
    busy = t.busy_s
    if busy <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / t.window_s)


def roofline_pct(ctx, pattern: str, bound_s_per_call: float) -> Optional[float]:
    """The calls' bound over their measured time, in %; None where no call was traced."""
    seconds, calls = ctx["trace"].kernel_seconds(re.compile(pattern).search)
    if calls == 0 or seconds <= 0 or not math.isfinite(bound_s_per_call):
        return None
    return 100.0 * bound_s_per_call * calls / seconds
