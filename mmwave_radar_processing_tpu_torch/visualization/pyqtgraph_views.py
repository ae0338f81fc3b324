"""pyqtgraph/OpenGL views for the Qt viewer, the real-time rendering tier (JAX: ``visualization/pyqtgraph_views.py``).

ImageItem heatmaps with physical extents (the image set transposed to
``[x, y]``, ``setRect`` from the bin grids, auto-levelled, a LUT colormap)
and an OpenGL ``GLViewWidget`` point cloud with a velocity colorbar: one
widget class a registry view name, each honouring the payload contracts of
the matplotlib views in :mod:`.views` (same keys, same dB semantics), so
the Qt shell swaps tiers with ``backend="pyqtgraph"``
(:func:`.qt_shell.build_main_window`).  Payloads are host arrays (the
controller's ``to_host``).  pyqtgraph, Qt and matplotlib are imported by
:func:`get_pg_view_classes` only; without pyqtgraph it raises
``ImportError`` and the shell keeps the matplotlib tier.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def _db(x):
    return 20.0 * np.log10(np.maximum(np.abs(x), 1e-12))


def get_pg_view_classes() -> Dict[str, type]:
    """The pyqtgraph view classes by view name (raises ``ImportError`` without pyqtgraph)."""
    import pyqtgraph as pg
    from pyqtgraph.Qt import QtCore, QtWidgets

    QRectF = QtCore.QRectF

    class PgBaseView(QtWidgets.QWidget):
        """The set_data / update_view / latest_payload contract of views.BaseView."""

        def __init__(self, parent=None, db_mode: bool = True, **_):
            super().__init__(parent)
            self.db_mode = db_mode
            self.latest_payload = None

        def set_data(self, payload) -> None:
            self.latest_payload = payload
            self.update_view(payload)

        def set_db_mode(self, enabled: bool) -> None:
            self.db_mode = bool(enabled)
            if self.latest_payload is not None:
                self.update_view(self.latest_payload)

        def update_view(self, payload) -> None:  # pragma: no cover - abstract
            raise NotImplementedError

    class PgHeatmapView(PgBaseView):
        """ImageItem heatmap with physical extents."""

        x_key = "vel_bins"
        y_key = "range_bins"
        x_label = "Velocity (m/s)"
        y_label = "Range (m)"
        title = "Range-Doppler Heatmap"

        def __init__(self, parent=None, db_mode: bool = True, **kw):
            super().__init__(parent, db_mode=db_mode, **kw)
            layout = QtWidgets.QVBoxLayout(self)
            self.plot = pg.PlotWidget()
            self.image = pg.ImageItem()
            self.plot.addItem(self.image)
            self.plot.setLabel("bottom", self.x_label)
            self.plot.setLabel("left", self.y_label)
            self.plot.setTitle(self.title)
            layout.addWidget(self.plot)
            self.set_colormap("viridis")

        def set_colormap(self, name: str = "viridis") -> None:
            try:
                self.image.setLookupTable(pg.colormap.get(name).getLookupTable())
            except Exception:
                pass

        def _bins(self, payload):
            return payload.get(self.x_key), payload.get(self.y_key)

        def update_view(self, payload: Dict[str, Any]) -> None:
            if not isinstance(payload, dict):
                return
            data = np.asarray(payload.get("data"))
            if data.size == 0:
                return
            # processor output is [y, x]; pyqtgraph images index [x, y]
            display = _db(data.T) if self.db_mode else np.abs(data.T)
            self.image.setImage(display, autoLevels=True)
            xb, yb = self._bins(payload)
            if xb is not None and yb is not None:
                xb, yb = np.asarray(xb), np.asarray(yb)
                self.image.setRect(QRectF(
                    float(xb[0]), float(yb[0]),
                    float(xb[-1] - xb[0]), float(yb[-1] - yb[0]),
                ))
            suffix = " (dB)" if self.db_mode else " (mag)"
            self.plot.setTitle(self.title + suffix)

    class PgRangeDopplerView(PgHeatmapView):
        pass

    class PgRangeAngleView(PgHeatmapView):
        x_key, y_key = "angle_bins", "range_bins"
        x_label, y_label = "Angle (rad)", "Range (m)"
        title = "Range-Angle Heatmap"

    class PgDopplerAzimuthView(PgHeatmapView):
        x_key, y_key = "valid_angle_bins", "vel_bins"
        x_label, y_label = "Angle (rad)", "Velocity (m/s)"
        title = "Doppler-Azimuth Heatmap"

        def _bins(self, payload):
            data = np.asarray(payload.get("data"))
            yb = payload.get("zoomed_vel_bins")
            if yb is None or len(np.asarray(yb)) != data.shape[0]:
                yb = payload.get(self.y_key)
            # [vel, angle] -> image [x=angle, y=vel]
            return payload.get(self.x_key), yb

    class PgMicroDopplerView(PgHeatmapView):
        x_key, y_key = "time_bins", "vel_bins"
        x_label, y_label = "Time (s)", "Velocity (m/s)"
        title = "Micro-Doppler Spectrogram"

    class PgRangeResponseView(PgBaseView):
        """Range profile as a PlotDataItem."""

        title = "Range Response"

        def __init__(self, parent=None, db_mode: bool = True, **kw):
            super().__init__(parent, db_mode=db_mode, **kw)
            layout = QtWidgets.QVBoxLayout(self)
            self.plot = pg.PlotWidget()
            self.curve = self.plot.plot(pen=pg.mkPen(width=2))
            self.plot.setLabel("bottom", "Range (m)")
            self.plot.setTitle(self.title)
            layout.addWidget(self.plot)

        def update_view(self, payload) -> None:
            data = np.asarray(payload.get("data"))
            if data.size == 0:
                return
            y = _db(data) if self.db_mode else np.abs(data)
            x = payload.get("range_bins")
            x = np.arange(y.size) if x is None else np.asarray(x)
            self.curve.setData(x[: y.size], y)

    class PgRangeDopplerDetectorView(PgRangeDopplerView):
        """Heatmap with the detections as ScatterPlotItem markers."""

        title = "Range-Doppler Detections"

        def __init__(self, parent=None, db_mode: bool = True, **kw):
            super().__init__(parent, db_mode=db_mode, **kw)
            self.markers = pg.ScatterPlotItem(
                symbol="x", size=10, pen=pg.mkPen("r", width=2), brush=None)
            self.plot.addItem(self.markers)

        def update_view(self, payload) -> None:
            resp = payload.get("rng_dop_resp")
            dets = np.asarray(payload.get("data", np.empty((0, 2))), int)
            base = dict(payload,
                        data=resp if resp is not None else np.zeros((2, 2)))
            super().update_view(base)
            rb, vb = payload.get("range_bins"), payload.get("vel_bins")
            if dets.size and rb is not None and vb is not None:
                self.markers.setData(np.asarray(vb)[dets[:, 1]],
                                     np.asarray(rb)[dets[:, 0]])
            else:
                self.markers.setData([], [])

    class PgRangeDetectorView(PgRangeResponseView):
        """Profile, threshold and detection markers."""

        title = "Range Detections"

        def __init__(self, parent=None, db_mode: bool = True, **kw):
            super().__init__(parent, db_mode=db_mode, **kw)
            self.thr_curve = self.plot.plot(
                pen=pg.mkPen("y", style=QtCore.Qt.PenStyle.DashLine))
            self.markers = pg.ScatterPlotItem(
                symbol="o", size=8, pen=pg.mkPen("r"), brush=pg.mkBrush("r"))
            self.plot.addItem(self.markers)

        def update_view(self, payload) -> None:
            resp = np.asarray(payload.get("range_resp", payload.get("data")))
            dets = np.asarray(payload.get("data", np.empty(0)), int).reshape(-1)
            rb = payload.get("range_bins")
            rb = np.arange(resp.size) if rb is None else np.asarray(rb)
            y = _db(resp) if self.db_mode else np.abs(resp)
            self.curve.setData(rb[: y.size], y)
            thr = payload.get("thresholds")
            if thr is not None:
                t = np.asarray(thr, float)
                t = _db(t) if self.db_mode else t
                finite = np.isfinite(t)
                self.thr_curve.setData(rb[: t.size][finite], t[finite])
            if dets.size:
                self.markers.setData(rb[dets], y[dets])
            else:
                self.markers.setData([], [])

    class PgAltitudeView(PgRangeResponseView):
        """Coarse profile with a marker line at the altitude."""

        title = "Altimeter"

        def __init__(self, parent=None, db_mode: bool = True, **kw):
            super().__init__(parent, db_mode=db_mode, **kw)
            self.marker = pg.InfiniteLine(
                angle=90, pen=pg.mkPen("r", style=QtCore.Qt.PenStyle.DashLine))
            self.plot.addItem(self.marker)

        def update_view(self, payload) -> None:
            coarse = payload.get("coarse_fft_data")
            if coarse is not None:
                super().update_view(dict(payload, data=coarse))
            alt = float(np.asarray(payload["data"]).reshape(()))
            self.marker.setValue(alt)

    class PgPointCloud3DView(PgBaseView):
        """GLScatterPlotItem 3D cloud with a velocity colorbar."""

        def __init__(self, parent=None, db_mode: bool = True,
                     min_vel: float = -0.25, max_vel: float = 0.25, **kw):
            super().__init__(parent, db_mode=db_mode, **kw)
            import pyqtgraph.opengl as gl
            from matplotlib import pyplot as plt

            self.min_vel, self.max_vel = min_vel, max_vel
            layout = QtWidgets.QHBoxLayout(self)
            self.gl_view = gl.GLViewWidget()
            self.gl_view.addItem(gl.GLGridItem())
            self.scatter = gl.GLScatterPlotItem(
                pos=np.zeros((0, 3)), color=(1, 1, 1, 1), size=5, pxMode=True)
            self.gl_view.addItem(self.scatter)
            self.gl_view.setCameraPosition(distance=10, elevation=30,
                                           azimuth=45)
            layout.addWidget(self.gl_view, stretch=1)
            self._lut = plt.get_cmap("viridis")(np.linspace(0, 1, 256))
            # velocity colorbar: 1x256 gradient ImageItem with physical rect
            cbw = pg.GraphicsLayoutWidget()
            cbw.setFixedWidth(80)
            cb_plot = cbw.addPlot()
            cb_plot.hideAxis("bottom")
            cb_plot.hideAxis("left")
            cb_plot.showAxis("right")
            cb_plot.getAxis("right").setLabel("Velocity (m/s)")
            cb_plot.setMouseEnabled(x=False, y=False)
            cb_img = pg.ImageItem()
            cb_img.setImage((self._lut[None] * 255).astype(np.uint8))
            cb_img.setRect(QRectF(0, self.min_vel, 1,
                                  self.max_vel - self.min_vel))
            cb_plot.addItem(cb_img)
            cb_plot.setYRange(self.min_vel, self.max_vel, padding=0)
            layout.addWidget(cbw)
            # kept as attributes so that headless tests can read the gradient's extents
            self._cb_img, self._cb_plot = cb_img, cb_plot

        def update_view(self, payload) -> None:
            data = payload.get("data") if isinstance(payload, dict) else payload
            pts = (np.asarray(data).reshape(-1, 4)
                   if np.size(data) else np.empty((0, 4)))
            if not pts.shape[0]:
                self.scatter.setData(pos=np.zeros((0, 3)))
                return
            t = np.clip((pts[:, 3] - self.min_vel)
                        / max(self.max_vel - self.min_vel, 1e-9), 0.0, 1.0)
            colors = self._lut[(t * 255).astype(int)]
            self.scatter.setData(pos=pts[:, :3], color=colors, size=5)

    class PgPointCloudView(PgPointCloud3DView):
        """The 2D registry key draws through the same GL cloud (one OpenGL point-cloud view)."""

    return {
        "range_doppler": PgRangeDopplerView,
        "range_response": PgRangeResponseView,
        "range_angle": PgRangeAngleView,
        "micro_doppler": PgMicroDopplerView,
        "doppler_azimuth": PgDopplerAzimuthView,
        "range_detector": PgRangeDetectorView,
        "range_doppler_detector": PgRangeDopplerDetectorView,
        "altitude": PgAltitudeView,
        "point_cloud": PgPointCloudView,
        "point_cloud_3d": PgPointCloud3DView,
    }


def pyqtgraph_available() -> bool:
    try:
        import pyqtgraph  # noqa: F401

        return True
    except Exception:
        return False
