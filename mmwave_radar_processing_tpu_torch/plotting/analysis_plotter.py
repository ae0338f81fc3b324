"""Error-analysis plots (JAX: ``plotting/analysis_plotter.py``).

The analyzers keep their errors on the host, so these plots draw numpy
arrays.  matplotlib is imported when a method draws.
"""

from __future__ import annotations

import numpy as np


def _new_ax(figsize):
    import matplotlib.pyplot as plt

    return plt.subplots(figsize=figsize)[1]


def _new_figure(figsize):
    import matplotlib.pyplot as plt

    return plt.figure(figsize=figsize)


class AnalysisPlotter:
    """CDF, histogram, time-series and summary views of estimation errors."""

    def __init__(self, font_size: int = 10):
        self.font_size = font_size

    def plot_error_cdf(self, errors, ax=None, label=None):
        if ax is None:
            ax = _new_ax((5, 4))
        e = np.sort(np.abs(np.asarray(errors)))
        cdf = np.arange(1, e.size + 1) / e.size
        ax.plot(e, cdf, label=label)
        ax.set_xlabel("|error| (m/s)", fontsize=self.font_size)
        ax.set_ylabel("CDF", fontsize=self.font_size)
        ax.grid(alpha=0.3)
        if label:
            ax.legend(fontsize=self.font_size - 2)
        return ax

    def plot_error_histogram(self, errors, ax=None, bins: int = 40):
        if ax is None:
            ax = _new_ax((5, 4))
        ax.hist(np.asarray(errors), bins=bins, alpha=0.8)
        ax.set_xlabel("error (m/s)", fontsize=self.font_size)
        ax.set_ylabel("count", fontsize=self.font_size)
        return ax

    def plot_error_time_series(self, errors, ax=None, frame_period_s=0.05):
        if ax is None:
            ax = _new_ax((6, 3))
        e = np.asarray(errors)
        ax.plot(np.arange(e.size) * frame_period_s, e)
        ax.set_xlabel("time (s)", fontsize=self.font_size)
        ax.set_ylabel("error (m/s)", fontsize=self.font_size)
        return ax

    def plot_est_vs_gt(self, est, gt, ax=None, label=""):
        if ax is None:
            ax = _new_ax((5, 4))
        ax.scatter(np.asarray(gt), np.asarray(est), s=4, alpha=0.5)
        lims = [min(np.min(gt), np.min(est)), max(np.max(gt), np.max(est))]
        ax.plot(lims, lims, "k--", lw=0.8)
        ax.set_xlabel(f"ground truth {label}", fontsize=self.font_size)
        ax.set_ylabel(f"estimated {label}", fontsize=self.font_size)
        return ax

    def plot_summary(self, analyzer, fig=None):
        """2x2 summary: norm CDF, norm time series, per-axis histograms, the report table."""
        if fig is None:
            fig = _new_figure((10, 8))
        axes = fig.subplots(2, 2)
        self.plot_error_cdf(analyzer.get_norm_errors(), ax=axes[0, 0],
                            label="norm")
        self.plot_error_time_series(analyzer.get_norm_errors(), ax=axes[0, 1])
        for errs, lbl in [(analyzer.get_x_errors(), "x"),
                          (analyzer.get_y_errors(), "y"),
                          (analyzer.get_z_errors(), "z")]:
            axes[1, 0].hist(errs, bins=30, alpha=0.5, label=lbl)
        axes[1, 0].legend(fontsize=self.font_size - 2)
        axes[1, 0].set_xlabel("error (m/s)", fontsize=self.font_size)
        try:
            report = analyzer.generate_report()
        except ImportError:  # the report is a pandas table; draw without it
            report = None
        if report is not None:
            axes[1, 1].axis("off")
            axes[1, 1].table(
                cellText=np.round(report.values, 4),
                rowLabels=report.index,
                colLabels=report.columns,
                loc="center",
            )
        fig.tight_layout()
        return fig

    def plot_per_axis_histograms(self, analyzer, fig=None, bins: int = 30):
        if fig is None:
            fig = _new_figure((12, 3))
        axes = fig.subplots(1, 4)
        for ax, (errs, lbl) in zip(
            axes,
            [(analyzer.get_x_errors(), "x"), (analyzer.get_y_errors(), "y"),
             (analyzer.get_z_errors(), "z"), (analyzer.get_norm_errors(), "norm")],
        ):
            ax.hist(errs, bins=bins)
            ax.set_title(lbl, fontsize=self.font_size)
        fig.tight_layout()
        return fig
