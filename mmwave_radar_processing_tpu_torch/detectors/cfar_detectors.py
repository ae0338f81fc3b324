"""CFAR detector objects: thin stateful facades over the threshold maps (JAX: ``detectors/cfar_detectors.py``).

Each detector binds its window geometry and its device at construction and
exposes ``detect(x)``, which returns detection indices and caches
``thresholds`` and ``noise_estimates`` (tensors on the detector's device) and
``detections`` (a numpy mask), like the reference.  ``threshold_map`` is the
functional entry point for code that keeps everything on the device.  The
signal may be numpy or a tensor of any float width; it is taken to float32
on the detector's device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Type

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops import cfar as cfar_ops
from mmwave_radar_processing_tpu_torch.processors.base import (
    as_float32,
    resolve_device,
)


class _BaseCFAR:
    def __init__(self, device) -> None:
        self.device = resolve_device(device)
        self.thresholds = None
        self.detections = None
        self.noise_estimates = None

    def threshold_map(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _detect_mask(self, x) -> np.ndarray:
        """Run the threshold map on ``x`` and cache its results."""
        x = as_float32(x, self.device)
        self.thresholds, self.noise_estimates = self.threshold_map(x)
        self.detections = (x > self.thresholds).cpu().numpy()
        return self.detections

    compute_alpha_ca = staticmethod(cfar_ops.alpha_ca)


class BaseCFAR1D(_BaseCFAR):
    """1D CFAR base: subclasses provide :meth:`threshold_map`."""

    def __init__(self, num_train: int, num_guard: int, pfa: float = 0.0, *,
                 device, **kwargs):
        super().__init__(device)
        self.num_train = int(num_train)
        self.num_guard = int(num_guard)
        self.pfa = pfa

    def detect(self, x) -> List[int]:
        """Detection indices where ``x > threshold`` (edges never detect)."""
        return np.flatnonzero(self._detect_mask(x)).tolist()

    def plot_detections(self, x, ax=None):
        """Debug plot: signal, threshold, noise estimate, detection markers.

        Always re-runs :meth:`detect` so the caches match ``x``.
        """
        import matplotlib.pyplot as plt

        x = np.asarray(x)
        self.detect(x)
        if ax is None:
            _, ax = plt.subplots(figsize=(8, 3.5))
        ax.plot(x, label="signal")
        thr = self.thresholds.cpu().numpy()
        ax.plot(np.where(np.isfinite(thr), thr, np.nan), "--",
                label="threshold")
        ax.plot(self.noise_estimates.cpu().numpy(), ":", label="noise est")
        det = np.flatnonzero(self.detections)
        ax.plot(det, x[det], "rv", label="detections")
        ax.set_xlabel("cell")
        ax.legend(fontsize=8)
        return ax


class BaseCFAR2D(_BaseCFAR):
    """2D CFAR base: subclasses provide :meth:`threshold_map`."""

    def __init__(self, num_train, num_guard, pfa: float = 0.0, *, device, **kwargs):
        super().__init__(device)
        self.num_train = tuple(int(v) for v in num_train)
        self.num_guard = tuple(int(v) for v in num_guard)
        self.pfa = pfa

    def detect(self, x) -> List[Tuple[int, int]]:
        """(row, col) detections in row-major order."""
        rows, cols = np.where(self._detect_mask(x))
        return list(zip(rows.tolist(), cols.tolist()))

    def plot_detections(self, x, ax=None):
        """Debug plot: magnitude heatmap + detection scatter.

        Always re-runs :meth:`detect` so the caches match ``x``.
        """
        import matplotlib.pyplot as plt

        x = np.asarray(x)
        self.detect(x)
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 4))
        im = ax.imshow(20 * np.log10(np.abs(x) + 1e-12), aspect="auto",
                       origin="lower")
        rows, cols = np.where(self.detections)
        ax.scatter(cols, rows, s=12, facecolors="none", edgecolors="r",
                   label="detections")
        ax.set_xlabel("col")
        ax.set_ylabel("row")
        ax.legend(fontsize=8)
        plt.colorbar(im, ax=ax)
        return ax


class CaCFAR1D(BaseCFAR1D):
    """Cell-averaging CFAR (1D)."""

    def threshold_map(self, x):
        return cfar_ops.ca_1d(
            x, num_train=self.num_train, num_guard=self.num_guard, pfa=self.pfa
        )


class GoCFAR1D(BaseCFAR1D):
    """Greatest-of CFAR (1D): max of one-sided training means."""

    def threshold_map(self, x):
        return cfar_ops.go_so_1d(
            x, num_train=self.num_train, num_guard=self.num_guard, pfa=self.pfa,
            greatest=True,
        )


class SoCFAR1D(BaseCFAR1D):
    """Smallest-of CFAR (1D): min of one-sided training means."""

    def threshold_map(self, x):
        return cfar_ops.go_so_1d(
            x, num_train=self.num_train, num_guard=self.num_guard, pfa=self.pfa,
            greatest=False,
        )


class OsCFAR1D(BaseCFAR1D):
    """Ordered-statistic CFAR (1D): rank-``int(rho*N)`` noise estimate."""

    def __init__(self, num_train: int, num_guard: int, rho: float, alpha: float, *,
                 device, **kw):
        super().__init__(num_train, num_guard, pfa=0.0, device=device)
        self.rho = float(rho)
        self.alpha = float(alpha)
        self.k_rank = cfar_ops.os_rank(rho, 2 * self.num_train)

    def threshold_map(self, x):
        return cfar_ops.os_1d(
            x, num_train=self.num_train, num_guard=self.num_guard,
            rho=self.rho, alpha=self.alpha,
        )


class CaCFAR2D(BaseCFAR2D):
    """Cell-averaging CFAR (2D)."""

    def threshold_map(self, x):
        return cfar_ops.ca_2d(
            x, num_train=self.num_train, num_guard=self.num_guard, pfa=self.pfa
        )


class OsCFAR2D(BaseCFAR2D):
    """Ordered-statistic CFAR (2D)."""

    def __init__(self, num_train, num_guard, rho: float, alpha: float, *,
                 device, **kw):
        super().__init__(num_train, num_guard, pfa=0.0, device=device)
        self.rho = float(rho)
        self.alpha = float(alpha)

    def threshold_map(self, x):
        return cfar_ops.os_2d(
            x, num_train=self.num_train, num_guard=self.num_guard,
            rho=self.rho, alpha=self.alpha,
        )


def get_detector_registry() -> Dict[str, Type]:
    """Name -> class map."""
    return {
        "ca_cfar_1d": CaCFAR1D,
        "ca_cfar_2d": CaCFAR2D,
        "os_cfar_1d": OsCFAR1D,
        "os_cfar_2d": OsCFAR2D,
        "go_cfar_1d": GoCFAR1D,
        "so_cfar_1d": SoCFAR1D,
    }
