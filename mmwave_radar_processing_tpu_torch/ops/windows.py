"""Spectral window constants (JAX counterpart: ``ops/windows.py``).

Windows are host-side numpy arrays folded into the DFT factor matrices, so
they cost nothing at run time.  ``hanning`` matches ``np.hanning``
(symmetric, M-1 denominator), as the reference uses throughout.
"""

from __future__ import annotations

import numpy as np


def hanning(m: int, dtype=np.float32) -> np.ndarray:
    """Symmetric Hann window of length ``m`` (numpy convention)."""
    return np.hanning(m).astype(dtype)
