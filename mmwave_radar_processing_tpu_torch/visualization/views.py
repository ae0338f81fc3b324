"""Headless matplotlib views of the viewer's payloads (JAX: ``visualization/views.py``).

Each view caches a payload in ``set_data`` and re-renders it; ``set_db_mode``
re-renders the cached payload with or without the ``20*log10`` transform.
Views draw host arrays onto a matplotlib Axes: the controller hands them
payloads that ``to_host`` has already brought off the device.  Heatmap views
keep the ``[row, col] -> [x, y]`` layout with physical extents from the
payload's bin grids.

matplotlib is imported only where a view needs pyplot (an Axes of its own,
a colour norm), never when this module is imported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _db(x):
    return 20.0 * np.log10(np.maximum(np.abs(x), 1e-12))


class BaseView:
    """Payload-caching view: ``set_data -> update_view``."""

    def __init__(self, ax=None, db_mode: bool = True):
        if ax is None:
            import matplotlib.pyplot as plt

            ax = plt.subplots()[1]
        self.ax = ax
        self.db_mode = db_mode
        self.cmap = "viridis"
        self.latest_payload: Optional[Dict] = None

    def set_data(self, payload: Dict) -> None:
        self.latest_payload = payload
        self.update_view(payload)

    def set_db_mode(self, enabled: bool) -> None:
        self.db_mode = enabled
        if self.latest_payload is not None:
            self.update_view(self.latest_payload)

    def set_colormap(self, cmap: str) -> None:
        """Re-render with a new colormap."""
        self.cmap = cmap
        if self.latest_payload is not None:
            self.update_view(self.latest_payload)

    def update_view(self, payload: Dict) -> None:
        raise NotImplementedError

    def _prep(self, data):
        return _db(data) if self.db_mode else np.abs(data)


class HeatmapView(BaseView):
    """2D magnitude map with physical extents; ``[row, col]`` -> ``[x, y]``."""

    x_key = "vel_bins"
    y_key = "range_bins"
    x_label = "velocity (m/s)"
    y_label = "range (m)"
    title = "Range-Doppler"

    def update_view(self, payload):
        data = self._prep(payload["data"])
        xb = payload.get(self.x_key)
        yb = payload.get(self.y_key)
        self.ax.clear()
        extent = None
        if xb is not None and yb is not None and np.size(xb) and np.size(yb):
            extent = [xb[0], xb[-1], yb[0], yb[-1]]
        self.ax.imshow(data, aspect="auto", origin="lower", extent=extent,
                       cmap=self.cmap)
        self.ax.set_xlabel(self.x_label)
        self.ax.set_ylabel(self.y_label)
        self.ax.set_title(self.title)


class RangeDopplerView(HeatmapView):
    pass


class RangeAngleView(HeatmapView):
    x_key, y_key = "angle_bins", "range_bins"
    x_label, title = "angle (rad)", "Range-Angle"


class MicroDopplerView(HeatmapView):
    x_key, y_key = "time_bins", "vel_bins"
    x_label, y_label, title = "history (s)", "velocity (m/s)", "Micro-Doppler"


class DopplerAzimuthView(HeatmapView):
    x_key, y_key = "valid_angle_bins", "vel_bins"
    x_label, y_label, title = "angle (rad)", "velocity (m/s)", "Doppler-Azimuth"

    def update_view(self, payload):
        # precise path: the rows follow the zoomed velocity grid when it has
        # one entry a row
        if payload.get("zoomed_vel_bins") is not None and np.size(
            payload["zoomed_vel_bins"]
        ) == np.shape(payload["data"])[0]:
            payload = dict(payload, vel_bins=payload["zoomed_vel_bins"])
        super().update_view(payload)


class RangeResponseView(BaseView):
    """1D range profile curve."""

    def update_view(self, payload):
        self.ax.clear()
        data = self._prep(payload["data"])
        bins = payload.get("range_bins")
        x = bins if bins is not None and np.size(bins) == np.size(data) else (
            np.arange(np.size(data))
        )
        self.ax.plot(x, data)
        self.ax.set_xlabel("range (m)")
        self.ax.set_ylabel("magnitude (dB)" if self.db_mode else "magnitude")
        self.ax.set_title("Range Response")


class RangeDetectorView(BaseView):
    """Profile, dashed CFAR threshold and detection markers."""

    def update_view(self, payload):
        self.ax.clear()
        resp = payload.get("range_resp")
        bins = payload.get("range_bins")
        dets = np.asarray(payload.get("data", []), int).reshape(-1)
        if resp is None or bins is None:
            return
        curve = self._prep(resp)
        self.ax.plot(bins, curve, label="profile")
        thr = payload.get("thresholds")
        if thr is not None:
            tcurve = self._prep(np.where(np.isfinite(thr), thr, np.nan))
            self.ax.plot(bins, tcurve, "--", label="threshold")
        if dets.size:
            self.ax.scatter(np.asarray(bins)[dets], curve[dets], c="r",
                            marker="x", label="detections", zorder=5)
        self.ax.legend()
        self.ax.set_title("Range Detector")


class RangeDopplerDetectorView(HeatmapView):
    """Range-Doppler magnitude heatmap with the detections scattered over it."""

    title = "RD Detections"

    def update_view(self, payload):
        resp = payload.get("rng_dop_resp")
        dets = np.asarray(payload.get("data", np.empty((0, 2))), int)
        base = dict(payload, data=resp if resp is not None else np.zeros((2, 2)))
        super().update_view(base)
        rb, vb = payload.get("range_bins"), payload.get("vel_bins")
        if dets.size and rb is not None and vb is not None:
            self.ax.scatter(np.asarray(vb)[dets[:, 1]], np.asarray(rb)[dets[:, 0]],
                            c="r", marker="x", zorder=5)


class AltitudeView(RangeResponseView):
    """Coarse profile with a marker line at the altitude."""

    def update_view(self, payload):
        coarse = payload.get("coarse_fft_data")
        alt = float(np.asarray(payload["data"]).reshape(()))
        if coarse is not None:
            super().update_view(dict(payload, data=coarse))
        self.ax.axvline(alt, color="r", ls="--", label=f"altitude {alt:.2f} m")
        self.ax.legend()
        self.ax.set_title("Altimeter")


class PointCloudView(BaseView):
    """Velocity-coloured (x, y) scatter of the point cloud."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._colorbar = None

    def update_view(self, payload):
        self.ax.clear()
        pts = np.asarray(payload["data"]).reshape(-1, 4) if np.size(
            payload["data"]
        ) else np.empty((0, 4))
        if pts.shape[0]:
            sc = self.ax.scatter(pts[:, 1], pts[:, 0], c=pts[:, 3], s=8,
                                 cmap="coolwarm")
            # one colorbar across redraws: a new one a frame would stack
            # bars, shrink the axes and leak artists over a playback
            if self._colorbar is None or self._colorbar.ax.figure is None:
                self._colorbar = self.ax.figure.colorbar(
                    sc, ax=self.ax, label="velocity (m/s)"
                )
            else:
                self._colorbar.update_normal(sc)
        self.ax.set_xlabel("y (m)")
        self.ax.set_ylabel("x (m)")
        self.ax.set_title("Point Cloud")


class PointCloud3DView(BaseView):
    """3D point cloud coloured by radial velocity, clipped to ``[min_vel, max_vel]``, with a colorbar in m/s.

    Takes the ``(N, 4)`` points as the payload's ``"data"`` or as the
    payload itself.
    """

    def __init__(self, ax=None, db_mode: bool = True,
                 min_vel: float = -0.25, max_vel: float = 0.25):
        if ax is None:
            import matplotlib.pyplot as plt

            ax = plt.figure().add_subplot(projection="3d")
        elif ax.name != "3d":
            # replace a 2D axes handed in by a generic shell with a 3D one
            # in the same figure slot
            fig, pos = ax.figure, ax.get_position()
            ax.remove()
            ax = fig.add_subplot(projection="3d")
            ax.set_position(pos)
        super().__init__(ax=ax, db_mode=db_mode)
        self.min_vel = min_vel
        self.max_vel = max_vel
        self._colorbar = None

    def update_view(self, payload):
        from matplotlib.colors import Normalize

        data = payload.get("data") if isinstance(payload, dict) else payload
        pts = np.asarray(data).reshape(-1, 4) if np.size(data) else np.empty((0, 4))
        self.ax.clear()
        if pts.shape[0]:
            sc = self.ax.scatter(
                pts[:, 0], pts[:, 1], pts[:, 2],
                c=np.clip(pts[:, 3], self.min_vel, self.max_vel),
                cmap=self.cmap, norm=Normalize(self.min_vel, self.max_vel), s=8,
            )
            if self._colorbar is None:
                self._colorbar = self.ax.figure.colorbar(
                    sc, ax=self.ax, shrink=0.7, label="Velocity (m/s)"
                )
            else:
                self._colorbar.update_normal(sc)
        self.ax.set_xlabel("x (m)")
        self.ax.set_ylabel("y (m)")
        self.ax.set_zlabel("z (m)")
        self.ax.set_title("Point Cloud (3D)")


VIEW_CLASSES = {
    "range_doppler": RangeDopplerView,
    "range_response": RangeResponseView,
    "range_angle": RangeAngleView,
    "micro_doppler": MicroDopplerView,
    "doppler_azimuth": DopplerAzimuthView,
    "range_detector": RangeDetectorView,
    "range_doppler_detector": RangeDopplerDetectorView,
    "altitude": AltitudeView,
    "point_cloud": PointCloudView,
    "point_cloud_3d": PointCloud3DView,
}
