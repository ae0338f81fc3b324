"""Spectral window constants (JAX counterpart: ``ops/windows.py``).

Windows are host-side numpy arrays folded into the DFT factor matrices or
multiplied into a cube, so they cost nothing at run time.  ``hanning`` and
``hamming`` match ``np.hanning`` and ``np.hamming`` (symmetric, M-1
denominator), as the reference uses throughout.
"""

from __future__ import annotations

import numpy as np


def hanning(m: int, dtype=np.float32) -> np.ndarray:
    """Symmetric Hann window of length ``m`` (numpy convention)."""
    return np.hanning(m).astype(dtype)


def hamming(m: int, dtype=np.float32) -> np.ndarray:
    """Symmetric Hamming window of length ``m`` (numpy convention)."""
    return np.hamming(m).astype(dtype)


def outer_window(*windows: np.ndarray) -> np.ndarray:
    """Separable multi-axis window as one broadcastable constant.

    ``outer_window(w_range, w_doppler)`` is the ``(len(w_range),
    len(w_doppler))`` product of the two; one multiply applies both.
    """
    out = windows[0]
    for w in windows[1:]:
        out = np.multiply.outer(out, w)
    return out
