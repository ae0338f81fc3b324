"""Altimeter and odometry plots (JAX: ``plotting/plotter_odometry.py``).

Profiles may be tensors on the processors' device; each goes through
``to_host`` when it is drawn.  matplotlib is imported when a method draws.
"""

from __future__ import annotations

import numpy as np

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.processors.base import to_host


def _new_ax(figsize=(6, 4)):
    import matplotlib.pyplot as plt

    return plt.subplots(figsize=figsize)[1]


class PlotterOdometryData:
    """Altimeter (coarse and zoom profiles, the altitude track) and velocity panels."""

    def __init__(self, config: RadarConfig, font_size: int = 10):
        self.config = config
        self.font_size = font_size

    def plot_altimeter_profiles(
        self, coarse_mag, range_bins, zoom_mag=None, zoom_bins=None,
        altitude_m=None, peaks_m=None, ax=None,
    ):
        """Coarse (and optional zoom) range profile with the tracked altitude."""
        if ax is None:
            ax = _new_ax()
        db = 20 * np.log10(np.abs(to_host(coarse_mag)) + 1e-12)
        ax.plot(to_host(range_bins), db, label="coarse")
        if zoom_mag is not None:
            zdb = 20 * np.log10(np.abs(to_host(zoom_mag)) + 1e-12)
            ax.plot(to_host(zoom_bins), zdb, label="zoom")
        peaks_m = to_host(peaks_m)
        if peaks_m is not None and peaks_m.size:
            ax.axvline(np.min(peaks_m), color="g", ls=":", label="ground peak")
        if altitude_m is not None:
            ax.axvline(altitude_m, color="r", ls="--", label="altitude")
        ax.set_xlabel("range (m)", fontsize=self.font_size)
        ax.set_ylabel("magnitude (dB)", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2)
        return ax

    def plot_altitude_history(self, est_history, gt_history=None, ax=None,
                              frame_period_s: float = 0.05):
        if ax is None:
            ax = _new_ax()
        est = np.asarray(est_history)
        t = np.arange(est.shape[0]) * frame_period_s
        ax.plot(t, est, label="estimated")
        if gt_history is not None:
            ax.plot(t, np.asarray(gt_history), "--", label="ground truth")
        ax.set_xlabel("time (s)", fontsize=self.font_size)
        ax.set_ylabel("altitude (m)", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2)
        return ax

    def plot_altitude_error(self, est_history, gt_history, ax=None,
                            frame_period_s: float = 0.05):
        if ax is None:
            ax = _new_ax()
        err = np.asarray(est_history) - np.asarray(gt_history)
        t = np.arange(err.shape[0]) * frame_period_s
        ax.plot(t, err)
        ax.axhline(0.0, color="k", lw=0.5)
        ax.set_xlabel("time (s)", fontsize=self.font_size)
        ax.set_ylabel("altitude error (m)", fontsize=self.font_size)
        return ax

    def plot_velocity_panels(self, est_history, gt_history, fig=None,
                             frame_period_s: float = 0.05):
        """Per-axis velocity estimate against the ground truth, 3 stacked panels."""
        if fig is None:
            import matplotlib.pyplot as plt

            fig = plt.figure(figsize=(8, 8))
        axes = fig.subplots(3, 1, sharex=True)
        est = np.asarray(est_history)
        gt = np.asarray(gt_history)
        t = np.arange(est.shape[0]) * frame_period_s
        for i, lbl in enumerate("xyz"):
            axes[i].plot(t, est[:, i], label="est")
            axes[i].plot(t, gt[:, i], "--", label="gt")
            axes[i].set_ylabel(f"v{lbl} (m/s)", fontsize=self.font_size)
            axes[i].legend(fontsize=self.font_size - 2)
        axes[-1].set_xlabel("time (s)", fontsize=self.font_size)
        fig.tight_layout()
        return fig
