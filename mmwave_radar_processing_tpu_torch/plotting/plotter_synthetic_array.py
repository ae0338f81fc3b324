"""Synthetic-aperture plots (JAX: ``plotting/plotter_synthetic_array.py``).

The synthetic-array processor hands its results to the host itself (its
``process`` returns numpy, its geometry and cartesian image are numpy), so
these plots take host arrays; ``to_host`` lets them take a tensor too.
matplotlib is imported when a method draws.
"""

from __future__ import annotations

import numpy as np

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.processors.base import to_host


def _new_ax():
    import matplotlib.pyplot as plt

    return plt.subplots(figsize=(5, 4))[1]


class PlotterSyntheticArrayData:
    """Geometry scatter, beamformed slices, cartesian SAR image, array pattern, depth map."""

    def __init__(self, config: RadarConfig, min_threshold_dB: float = 40.0,
                 font_size: int = 10):
        self.config = config
        self.min_threshold_dB = min_threshold_dB
        self.font_size = font_size

    def _db(self, mag):
        db = 20 * np.log10(np.abs(to_host(mag)) + 1e-12)
        return np.maximum(db, db.max() - self.min_threshold_dB)

    def plot_array_geometry(self, array_geometry, ax=None):
        """Synthetic element positions (x, y), one colour a frame."""
        if ax is None:
            ax = _new_ax()
        geo = to_host(array_geometry)  # (F, 3, C)
        for f in range(geo.shape[0]):
            ax.scatter(geo[f, 0] * 100, geo[f, 1] * 100, s=8, label=f"frame {f}")
        ax.set_xlabel("x (cm)", fontsize=self.font_size)
        ax.set_ylabel("y (cm)", fontsize=self.font_size)
        ax.set_title("Synthetic array geometry", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2)
        return ax

    def plot_azimuth_slice(self, beamformed_resp, processor, el_idx: int = 0,
                           ax=None):
        """Range-azimuth dB map of the beamformed response at one elevation."""
        if ax is None:
            ax = _new_ax()
        data = self._db(to_host(beamformed_resp)[:, :, el_idx])
        extent = [np.rad2deg(processor.az_angle_bins_rad[0]),
                  np.rad2deg(processor.az_angle_bins_rad[-1]),
                  processor.range_bins[0], processor.range_bins[-1]]
        m = ax.imshow(data, aspect="auto", origin="lower", extent=extent,
                      cmap="viridis")
        ax.set_xlabel("azimuth (deg)", fontsize=self.font_size)
        ax.set_ylabel("range (m)", fontsize=self.font_size)
        ax.set_title("Beamformed response", fontsize=self.font_size)
        return m

    def plot_cartesian_image(self, processor, ax=None):
        """The processor's interpolated cartesian SAR image."""
        if ax is None:
            ax = _new_ax()
        img = self._db(processor.interpolated_beamformed_resp)
        m = ax.pcolormesh(processor.interp_y_s, processor.interp_x_s, img,
                          shading="auto", cmap="viridis")
        ax.set_xlabel("y (m)", fontsize=self.font_size)
        ax.set_ylabel("x (m)", fontsize=self.font_size)
        ax.set_title("SAR image (cartesian)", fontsize=self.font_size)
        return m

    def plot_array_pattern(self, pattern, processor, ax=None):
        """Normalized array-factor pattern against azimuth (elevation slice 0)."""
        if ax is None:
            ax = _new_ax()
        pat = to_host(pattern)[:, 0]
        ax.plot(np.rad2deg(processor.az_angle_bins_rad),
                20 * np.log10(pat + 1e-12))
        ax.set_xlabel("azimuth (deg)", fontsize=self.font_size)
        ax.set_ylabel("array factor (dB)", fontsize=self.font_size)
        ax.set_title("Synthetic array pattern", fontsize=self.font_size)
        return ax

    def plot_depth_map(self, beamformed_resp, processor, ax=None,
                       floor_dB: float = 40.0):
        """The range of the strongest return in each (az, el) cell, above a dB floor."""
        if ax is None:
            ax = _new_ax()
        mag = np.abs(to_host(beamformed_resp))  # (range, az, el)
        db = 20 * np.log10(mag + 1e-12)
        peak = db.max()
        best_rng = np.asarray(processor.range_bins)[np.argmax(mag, axis=0)]
        valid = db.max(axis=0) >= peak - floor_dB
        depth = np.where(valid, best_rng, np.nan)
        m = ax.imshow(depth.T, aspect="auto", origin="lower", cmap="viridis",
                      extent=[np.rad2deg(processor.az_angle_bins_rad[0]),
                              np.rad2deg(processor.az_angle_bins_rad[-1]),
                              np.rad2deg(processor.el_angle_bins_rad[0]),
                              np.rad2deg(processor.el_angle_bins_rad[-1] + 1e-3)])
        ax.set_xlabel("azimuth (deg)", fontsize=self.font_size)
        ax.set_ylabel("elevation (deg)", fontsize=self.font_size)
        ax.set_title("Depth map", fontsize=self.font_size)
        return m

    def plot_lidar_overlay(self, lidar_points, ax, max_range: float = None,
                           fov_rad: float = np.deg2rad(30)):
        """Lidar ground truth within the radar's field of view, over an axis."""
        pts = to_host(lidar_points)
        az = np.arctan2(pts[:, 1], pts[:, 0])
        rng = np.linalg.norm(pts[:, :2], axis=1)
        keep = np.abs(az) <= fov_rad
        if max_range:
            keep &= rng <= max_range
        ax.scatter(pts[keep, 1], pts[keep, 0], s=2, c="r", label="lidar")
        ax.legend(fontsize=self.font_size - 2)
        return ax

    def plot_compilation(self, processor, beamformed_resp, pattern=None,
                         lidar_points=None, fig=None):
        if fig is None:
            import matplotlib.pyplot as plt

            fig = plt.figure(figsize=(12, 8))
        axes = fig.subplots(2, 2)
        self.plot_array_geometry(processor.array_geometry, ax=axes[0, 0])
        self.plot_azimuth_slice(beamformed_resp, processor, ax=axes[0, 1])
        ax_cart = axes[1, 0]
        self.plot_cartesian_image(processor, ax=ax_cart)
        if lidar_points is not None:
            self.plot_lidar_overlay(lidar_points, ax_cart)
        if pattern is not None:
            self.plot_array_pattern(pattern, processor, ax=axes[1, 1])
        fig.tight_layout()
        return fig
