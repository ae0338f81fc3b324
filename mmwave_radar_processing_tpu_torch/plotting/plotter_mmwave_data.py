"""Per-frame mmWave response plots (JAX: ``plotting/plotter_mmwave_data.py``).

Every method draws onto a given matplotlib Axes (or makes one), renders
magnitudes in dB floored at ``max - min_threshold_dB``, and takes its
physical extents from the processor's bin grids and meshes.  Responses may
be tensors on the processors' device: each goes through ``to_host`` when
it is drawn, and a tensor that only a slice of is drawn (the raw ADC cube)
is sliced on its device first.  matplotlib is imported when a method draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.processors.base import to_host


def _to_db(mag, min_threshold_dB: float = 40.0) -> np.ndarray:
    db = 20.0 * np.log10(np.abs(to_host(mag)) + 1e-12)
    return np.maximum(db, db.max() - min_threshold_dB)


def _ensure_ax(ax):
    if ax is None:
        import matplotlib.pyplot as plt

        _, ax = plt.subplots(1, 1, figsize=(5, 4))
    return ax


class PlotterMmWaveData:
    """Plots of the processor family, and the 2x3 dashboard."""

    def __init__(
        self,
        config: RadarConfig,
        min_threshold_dB: float = 40.0,
        font_size: int = 10,
    ):
        self.config = config
        self.min_threshold_dB = min_threshold_dB
        self.font_size = font_size

    def _data(self, mag, convert_to_dB: bool) -> np.ndarray:
        return _to_db(mag, self.min_threshold_dB) if convert_to_dB else to_host(mag)

    # heatmaps ----------------------------------------------------------- #
    def plot_range_azimuth_heatmap_cart(self, resp_mag, processor, ax=None,
                                        convert_to_dB: bool = True):
        """Cartesian range-azimuth heatmap on the processor's (x, y) mesh."""
        ax = _ensure_ax(ax)
        m = ax.pcolormesh(processor.y_s, processor.x_s, self._data(resp_mag, convert_to_dB),
                          shading="gouraud", cmap="viridis")
        ax.set_xlabel("y (m)", fontsize=self.font_size)
        ax.set_ylabel("x (m)", fontsize=self.font_size)
        ax.set_title("Range-Azimuth (cart)", fontsize=self.font_size)
        return m

    def plot_range_azimuth_heatmap_polar(self, resp_mag, processor, ax=None,
                                         convert_to_dB: bool = True):
        ax = _ensure_ax(ax)
        extent = [np.rad2deg(processor.angle_bins[0]),
                  np.rad2deg(processor.angle_bins[-1]),
                  processor.range_bins[0], processor.range_bins[-1]]
        m = ax.imshow(self._data(resp_mag, convert_to_dB), aspect="auto", origin="lower",
                      extent=extent, cmap="viridis")
        ax.set_xlabel("azimuth (deg)", fontsize=self.font_size)
        ax.set_ylabel("range (m)", fontsize=self.font_size)
        ax.set_title("Range-Azimuth (polar)", fontsize=self.font_size)
        return m

    def plot_range_doppler_heatmap(self, rd_mag, processor, ax=None,
                                   convert_to_dB: bool = True):
        ax = _ensure_ax(ax)
        extent = [processor.vel_bins[0], processor.vel_bins[-1],
                  processor.range_bins[0], processor.range_bins[-1]]
        m = ax.imshow(self._data(rd_mag, convert_to_dB), aspect="auto", origin="lower",
                      extent=extent, cmap="viridis")
        ax.set_xlabel("velocity (m/s)", fontsize=self.font_size)
        ax.set_ylabel("range (m)", fontsize=self.font_size)
        ax.set_title("Range-Doppler", fontsize=self.font_size)
        return m

    def plot_micro_doppler(self, micro_resp, processor, ax=None,
                           convert_to_dB: bool = True):
        ax = _ensure_ax(ax)
        extent = [processor.time_bins[0], processor.time_bins[-1],
                  processor.vel_bins[0], processor.vel_bins[-1]]
        m = ax.imshow(self._data(micro_resp, convert_to_dB), aspect="auto", origin="lower",
                      extent=extent, cmap="viridis")
        ax.set_xlabel("history (s)", fontsize=self.font_size)
        ax.set_ylabel("velocity (m/s)", fontsize=self.font_size)
        ax.set_title("Micro-Doppler", fontsize=self.font_size)
        return m

    def plot_doppler_azimuth(self, resp_mag, processor, ax=None,
                             convert_to_dB: bool = True, peaks=None,
                             gt_predictions=None, vel_bins=None,
                             vd_ground_truth=None, vd_estimated=None,
                             title: str = "Doppler-Azimuth"):
        """Doppler-azimuth map with optional peak, ground-truth and estimate overlays.

        ``peaks`` are ``(angle_rad, vel)`` rows drawn as red crosses;
        ``vd_ground_truth`` / ``vd_estimated`` are per-valid-angle velocity
        curves drawn orange / white; ``gt_predictions`` is an older name of
        ``vd_ground_truth``.
        """
        ax = _ensure_ax(ax)
        data = self._data(resp_mag, convert_to_dB)
        vb = to_host(vel_bins) if vel_bins is not None else processor.vel_bins
        extent = [np.rad2deg(processor.valid_angle_bins[0]),
                  np.rad2deg(processor.valid_angle_bins[-1]),
                  vb[0], vb[-1]]
        m = ax.imshow(data, aspect="auto", origin="lower", extent=extent,
                      cmap="viridis")
        peaks = to_host(peaks)
        if peaks is not None and peaks.size:
            peaks = np.atleast_2d(peaks)
            ax.scatter(np.rad2deg(peaks[:, 0]), peaks[:, 1], c="r", marker="x",
                       s=20, label="Detected Peaks")
        vd_ground_truth = to_host(gt_predictions if vd_ground_truth is None
                                  else vd_ground_truth)
        vd_estimated = to_host(vd_estimated)
        angles_deg = np.rad2deg(np.asarray(processor.valid_angle_bins))
        if vd_ground_truth is not None and vd_ground_truth.size:
            ax.plot(angles_deg, vd_ground_truth, color="orange",
                    lw=2, label="Ground Truth Velocity")
        if vd_estimated is not None and vd_estimated.size:
            ax.plot(angles_deg, vd_estimated, color="white",
                    lw=2, label="Estimated Velocity")
        if ax.get_legend_handles_labels()[0]:
            ax.legend(fontsize=self.font_size - 2)
        ax.set_xlabel("azimuth (deg)", fontsize=self.font_size)
        ax.set_ylabel("velocity (m/s)", fontsize=self.font_size)
        ax.set_ylim(float(vb.min()), float(vb.max()))
        ax.set_title(title, fontsize=self.font_size)
        return m

    def plot_zoomed_doppler_azimuth(self, resp_mag, processor, ax=None,
                                    convert_to_dB: bool = True, peaks=None,
                                    vd_ground_truth=None, vd_estimated=None):
        """The precise (zoom) Doppler-azimuth map on the processor's ``zoomed_vel_bins``.

        The same overlays as the coarse panel; the rows that
        ``zoomed_vel_valid`` marks as padding are blanked, so the dB floor
        draws them dark.
        """
        if processor.zoomed_vel_bins is None:
            raise ValueError(
                "no zoomed velocity grid: run the processor with "
                "use_precise_fft=True before plotting the zoomed response"
            )
        resp_mag = to_host(resp_mag)
        row_valid = getattr(processor, "zoomed_vel_valid", None)
        if row_valid is not None:
            resp_mag = np.where(to_host(row_valid)[:, None], resp_mag, 0.0)
        return self.plot_doppler_azimuth(
            resp_mag, processor, ax=ax, convert_to_dB=convert_to_dB,
            peaks=peaks, vd_ground_truth=vd_ground_truth,
            vd_estimated=vd_estimated,
            vel_bins=to_host(processor.zoomed_vel_bins),
            title="Zoomed Doppler-Azimuth",
        )

    # 1D ----------------------------------------------------------------- #
    def plot_range_profile(self, rng_resp, processor, ax=None,
                           peaks_m=None, peak_vals=None, thresholds=None):
        ax = _ensure_ax(ax)
        db = 20.0 * np.log10(np.abs(to_host(rng_resp)) + 1e-12)
        ax.plot(processor.range_bins, db, label="profile")
        if thresholds is not None:
            thr = 20.0 * np.log10(np.maximum(to_host(thresholds), 1e-12))
            finite = np.isfinite(thr)
            ax.plot(np.asarray(processor.range_bins)[finite], thr[finite], "--",
                    label="CFAR threshold")
        peaks_m = to_host(peaks_m)
        if peaks_m is not None and peaks_m.size:
            vals = to_host(peak_vals) if peak_vals is not None else np.interp(
                peaks_m, processor.range_bins, db)
            ax.scatter(peaks_m, vals, c="r", marker="x", label="peaks")
        ax.set_xlabel("range (m)", fontsize=self.font_size)
        ax.set_ylabel("magnitude (dB)", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2)
        return ax

    def plot_raw_adc(self, adc_cube, ax=None, rx_idx: int = 0, chirp_idx: int = 0):
        ax = _ensure_ax(ax)
        sig = to_host(adc_cube[rx_idx, :, chirp_idx])
        ax.plot(np.real(sig), label="I")
        ax.plot(np.imag(sig), label="Q")
        ax.set_xlabel("sample", fontsize=self.font_size)
        ax.set_title("Raw ADC", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2)
        return ax

    # time series --------------------------------------------------------- #
    def plot_estimates_vs_gt(self, est_history, gt_history, ax=None,
                             labels=("x", "y", "z"), frame_period_s: float = 0.05):
        ax = _ensure_ax(ax)
        est = np.asarray(est_history)
        gt = np.asarray(gt_history)
        t = np.arange(est.shape[0]) * frame_period_s
        for i, lbl in enumerate(labels[: est.shape[1]]):
            ax.plot(t, est[:, i], label=f"est {lbl}")
            ax.plot(t, gt[:, i], "--", label=f"gt {lbl}")
        ax.set_xlabel("time (s)", fontsize=self.font_size)
        ax.set_ylabel("velocity (m/s)", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2, ncol=3)
        return ax

    def plot_estimate_error(self, est_history, gt_history, ax=None,
                            frame_period_s: float = 0.05):
        ax = _ensure_ax(ax)
        err = np.linalg.norm(np.asarray(est_history) - np.asarray(gt_history), axis=1)
        t = np.arange(err.shape[0]) * frame_period_s
        ax.plot(t, err)
        ax.set_xlabel("time (s)", fontsize=self.font_size)
        ax.set_ylabel("|error| (m/s)", fontsize=self.font_size)
        return ax

    # dashboard ----------------------------------------------------------- #
    def plot_compilation(
        self,
        adc_cube,
        range_doppler=None,
        range_angle=None,
        micro_doppler=None,
        doppler_azimuth=None,
        camera_frame=None,
        zoomed_doppler_azimuth=None,
        processors: Optional[dict] = None,
        fig=None,
    ):
        """The 2x3 dashboard.

        Cells: ``[0,0]`` raw ADC, ``[0,1]`` range-Doppler, ``[0,2]``
        Doppler-azimuth, ``[1,0]`` cartesian range-azimuth, ``[1,1]``
        micro-Doppler, ``[1,2]`` the camera, or without a camera frame the
        precise ``zoomed_doppler_azimuth`` response (its processor, under
        ``processors["zoomed_doppler_azimuth"]``, run with
        ``use_precise_fft=True``).  ``processors`` maps a panel's name to its
        processor (for bins and meshes); missing panels stay blank.
        """
        processors = processors or {}
        if fig is None:
            import matplotlib.pyplot as plt

            fig = plt.figure(figsize=(15, 10))
        axes = fig.subplots(2, 3)
        fig.subplots_adjust(wspace=0.3, hspace=0.30)
        self.plot_raw_adc(adc_cube, ax=axes[0, 0])
        if range_doppler is not None:
            self.plot_range_doppler_heatmap(range_doppler,
                                            processors["range_doppler"], ax=axes[0, 1])
        if doppler_azimuth is not None:
            self.plot_doppler_azimuth(doppler_azimuth,
                                      processors["doppler_azimuth"], ax=axes[0, 2])
        if range_angle is not None:
            self.plot_range_azimuth_heatmap_cart(range_angle,
                                                 processors["range_angle"], ax=axes[1, 0])
        if micro_doppler is not None:
            self.plot_micro_doppler(micro_doppler,
                                    processors["micro_doppler"], ax=axes[1, 1])
        if camera_frame is not None:
            axes[1, 2].imshow(np.asarray(camera_frame))
            axes[1, 2].set_title("Frontal Camera View", fontsize=self.font_size)
            axes[1, 2].axis("off")
        elif zoomed_doppler_azimuth is not None:
            self.plot_zoomed_doppler_azimuth(
                zoomed_doppler_azimuth,
                processors["zoomed_doppler_azimuth"], ax=axes[1, 2],
            )
        return fig
