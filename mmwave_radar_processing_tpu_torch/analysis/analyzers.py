"""Error-statistics analyzers of the port (JAX: ``analysis/analyzers.py``; numpy only).

Same metric definitions as the reference: signed/absolute per-axis error,
vector-norm error, and {Mean, Median, RMSE, 90% tail} summaries
(``base_analyzer.py:16-91``, ``velocity_analyzer.py:22-132``), reported as a
pandas table.  ``pandas`` is imported by :meth:`VelocityAnalyzer.generate_report`
alone, so the module imports where pandas is not installed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class BaseAnalyzer:
    """Error computation + summary statistics."""

    def compute_error(
        self, estimated: np.ndarray, ground_truth: np.ndarray, method: str = "absolute"
    ) -> np.ndarray:
        if estimated.shape != ground_truth.shape:
            raise ValueError(
                f"Shape mismatch: estimated {estimated.shape} vs ground truth "
                f"{ground_truth.shape}"
            )
        diff = estimated - ground_truth
        if method == "absolute":
            return np.abs(diff)
        if method == "signed":
            return diff
        raise ValueError(f"Unknown error computation method: {method}")

    def compute_norm_error(
        self, estimated_vectors: np.ndarray, ground_truth_vectors: np.ndarray
    ) -> np.ndarray:
        if estimated_vectors.shape != ground_truth_vectors.shape:
            raise ValueError(
                f"Shape mismatch: estimated {estimated_vectors.shape} vs ground "
                f"truth {ground_truth_vectors.shape}"
            )
        return np.linalg.norm(estimated_vectors - ground_truth_vectors, axis=1)

    def compute_summary_statistics(self, data: np.ndarray) -> Dict[str, float]:
        if data.size == 0:
            return {"Mean": 0.0, "Median": 0.0, "RMSE": 0.0, "90% Tail": 0.0}
        return {
            "Mean": float(np.mean(data)),
            "Median": float(np.median(data)),
            "RMSE": float(np.sqrt(np.mean(data**2))),
            "90% Tail": float(np.percentile(np.abs(data), 90)),
        }


class VelocityAnalyzer(BaseAnalyzer):
    """Per-axis + norm velocity error analysis over (N, 3) histories."""

    def __init__(self) -> None:
        self.x_errors: Optional[np.ndarray] = None
        self.y_errors: Optional[np.ndarray] = None
        self.z_errors: Optional[np.ndarray] = None
        self.norm_errors: Optional[np.ndarray] = None

    def analyze(
        self,
        history_estimated: np.ndarray,
        history_gt: np.ndarray,
        error_method: str = "signed",
    ) -> None:
        history_estimated = np.asarray(history_estimated)
        history_gt = np.asarray(history_gt)
        if history_estimated.shape != history_gt.shape:
            raise ValueError(
                f"Shape mismatch: Estimated {history_estimated.shape}, "
                f"GT {history_gt.shape}"
            )
        if history_estimated.shape[1] != 3:
            raise ValueError(
                f"Expected 3D velocity vectors, got shape {history_estimated.shape}"
            )
        self.x_errors = self.compute_error(
            history_estimated[:, 0], history_gt[:, 0], error_method
        )
        self.y_errors = self.compute_error(
            history_estimated[:, 1], history_gt[:, 1], error_method
        )
        self.z_errors = self.compute_error(
            history_estimated[:, 2], history_gt[:, 2], error_method
        )
        self.norm_errors = self.compute_norm_error(history_estimated, history_gt)

    def _require(self, attr):
        val = getattr(self, attr)
        if val is None:
            raise ValueError("Analysis not performed. Call analyze() first.")
        return val

    def get_x_errors(self) -> np.ndarray:
        return self._require("x_errors")

    def get_y_errors(self) -> np.ndarray:
        return self._require("y_errors")

    def get_z_errors(self) -> np.ndarray:
        return self._require("z_errors")

    def get_norm_errors(self) -> np.ndarray:
        return self._require("norm_errors")

    def generate_report(self):
        """The summary table (a ``pandas.DataFrame``): rows X, Y, Z, Norm."""
        import pandas as pd

        self._require("x_errors")
        stats = {
            name: self.compute_summary_statistics(data)
            for name, data in [
                ("X", self.x_errors),
                ("Y", self.y_errors),
                ("Z", self.z_errors),
                ("Norm", self.norm_errors),
            ]
        }
        return pd.DataFrame(stats).T
