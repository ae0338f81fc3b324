"""Optional Qt shell of the viewer (needs PyQt6 and a display; JAX: ``visualization/qt_shell.py``).

A thin widget layer over :class:`ShellLogic`, which holds the selection,
caching and browse behaviour without Qt: a control panel (play/pause, a
frame slider, a dB toggle, movie export, dataset/config/parameter browse
dialogs) and a grid of cells, each with its view ``QComboBox`` and a
matplotlib canvas, or a pyqtgraph widget with ``backend="pyqtgraph"``.
The processors run on the controller's device; the cells draw its host
payloads.  Qt, matplotlib and pyqtgraph are imported when the window is
built, so the rest of the package never needs them.
"""

from __future__ import annotations

from typing import List, Optional


def build_main_window(controller, view_keys: Optional[List[str]] = None,
                      interval_ms: int = 50, backend: str = "matplotlib"):
    """Construct (but do not show) the viewer MainWindow.

    Apart from :func:`run_qt_viewer` so that offscreen tests can build the
    whole widget tree without entering the event loop.

    ``backend``: the cells' rendering tier, ``"matplotlib"`` (the default,
    testable headless) or ``"pyqtgraph"`` (the real-time tier of
    :mod:`.pyqtgraph_views`, which needs the ``pyqtgraph`` package).
    """
    from PyQt6 import QtCore, QtWidgets
    from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg
    from matplotlib.figure import Figure

    from mmwave_radar_processing_tpu_torch.visualization.shell_logic import ShellLogic

    if backend == "pyqtgraph":
        from mmwave_radar_processing_tpu_torch.visualization.pyqtgraph_views import (
            get_pg_view_classes,
        )

        pg_view_classes = get_pg_view_classes()

    class MainWindow(QtWidgets.QMainWindow):
        def __init__(self):
            super().__init__()
            self.setWindowTitle("mmWave Radar Viewer")
            self.logic = ShellLogic(controller, num_cells=4,
                                    initial_keys=view_keys)
            central = QtWidgets.QWidget()
            layout = QtWidgets.QVBoxLayout(central)

            # --- control panel ---------------------------------------- #
            controls = QtWidgets.QHBoxLayout()
            self.play_btn = QtWidgets.QPushButton("Play")
            self.play_btn.clicked.connect(self.toggle_play)
            controls.addWidget(self.play_btn)
            self.slider = QtWidgets.QSlider(QtCore.Qt.Orientation.Horizontal)
            self.slider.setMaximum(max(controller.dataset_model.num_frames - 1, 0))
            self.slider.valueChanged.connect(self.seek)
            controls.addWidget(self.slider)
            self.db_box = QtWidgets.QCheckBox("dB")
            self.db_box.setChecked(True)
            self.db_box.stateChanged.connect(self.toggle_db)
            controls.addWidget(self.db_box)
            for label, handler in [
                ("Browse Dataset", self.browse_dataset),
                ("Load Config", self.browse_config),
                ("Load Params", self.browse_params),
                ("Export Movie", self.export_movie),
            ]:
                btn = QtWidgets.QPushButton(label)
                btn.clicked.connect(handler)
                controls.addWidget(btn)
            layout.addLayout(controls)

            # --- 2x2 per-cell view grid -------------------------------- #
            self.backend = backend
            grid = QtWidgets.QGridLayout()
            self.cell_combos: List[QtWidgets.QComboBox] = []
            self.cell_figs: List[Figure] = []
            self.cell_canvases: List[FigureCanvasQTAgg] = []
            self.cell_boxes: List[QtWidgets.QVBoxLayout] = []
            self.cell_widgets: List[Optional[QtWidgets.QWidget]] = []
            for cell in range(self.logic.num_cells):
                box = QtWidgets.QVBoxLayout()
                combo = QtWidgets.QComboBox()
                for key in self.logic.options:
                    combo.addItem(key or "(none)", key)
                combo.currentIndexChanged.connect(
                    lambda _idx, c=cell: self.on_combo_changed(c)
                )
                box.addWidget(combo)
                if backend == "pyqtgraph":
                    self.cell_widgets.append(None)
                else:
                    fig = Figure(figsize=(5, 4))
                    canvas = FigureCanvasQTAgg(fig)
                    box.addWidget(canvas)
                    self.cell_figs.append(fig)
                    self.cell_canvases.append(canvas)
                cellw = QtWidgets.QWidget()
                cellw.setLayout(box)
                grid.addWidget(cellw, cell // 2, cell % 2)
                self.cell_combos.append(combo)
                self.cell_boxes.append(box)
            layout.addLayout(grid)
            self.setCentralWidget(central)

            if backend == "pyqtgraph":
                # ImageItem/GL items repaint on setData; no canvas to drive
                self.logic.set_render_callback(lambda cell: None)
            else:
                self.logic.set_render_callback(
                    lambda cell: self.cell_canvases[cell].draw_idle()
                )
            for cell, key in enumerate(self.logic.panel.assignments):
                self._sync_combo(cell, key)
                self._rebuild_cell_view(cell, key)

            self.timer = QtCore.QTimer()
            self.timer.setInterval(interval_ms)
            self.timer.timeout.connect(self.tick)
            self.playing = False
            self.frame = 0

        # cell plumbing ------------------------------------------------- #
        def _sync_combo(self, cell: int, key: Optional[str]):
            combo = self.cell_combos[cell]
            combo.blockSignals(True)
            combo.setCurrentIndex(combo.findData(key))
            combo.blockSignals(False)

        def _rebuild_cell_view(self, cell: int, key: Optional[str]):
            if self.backend == "pyqtgraph":
                old = self.cell_widgets[cell]
                if old is not None:
                    self.cell_boxes[cell].removeWidget(old)
                    old.deleteLater()
                    self.cell_widgets[cell] = None
                if key is None:
                    self.logic.bind_cell_view(cell, None)
                else:
                    view = pg_view_classes[controller.registry[key].view_name](
                        db_mode=self.db_box.isChecked())
                    self.cell_boxes[cell].addWidget(view)
                    self.cell_widgets[cell] = view
                    self.logic.bind_cell_view(cell, view)
                return
            fig = self.cell_figs[cell]
            fig.clear()
            if key is None:
                self.logic.bind_cell_view(cell, None)
            else:
                ax = fig.add_subplot(111)
                view = self.logic.view_class_for(key)(
                    ax=ax, db_mode=self.db_box.isChecked()
                )
                self.logic.bind_cell_view(cell, view)
            self.cell_canvases[cell].draw_idle()

        def on_combo_changed(self, cell: int):
            key = self.cell_combos[cell].currentData()
            self._rebuild_cell_view(cell, key)
            for changed in self.logic.select_view(cell, key):
                if changed != cell:  # uniqueness rule cleared another cell
                    self._sync_combo(changed,
                                     self.logic.panel.assignments[changed])
                    self._rebuild_cell_view(
                        changed, self.logic.panel.assignments[changed]
                    )

        # playback ------------------------------------------------------- #
        def tick(self):
            if self.frame >= controller.dataset_model.num_frames:
                self.toggle_play()
                return
            controller.process_next_frame(self.frame)
            self.slider.blockSignals(True)
            self.slider.setValue(self.frame)
            self.slider.blockSignals(False)
            self.frame += 1

        def toggle_play(self):
            self.playing = not self.playing
            self.play_btn.setText("Pause" if self.playing else "Play")
            (self.timer.start if self.playing else self.timer.stop)()

        def seek(self, idx):
            self.frame = idx
            controller.process_next_frame(idx)

        def toggle_db(self, state):
            enabled = bool(state)
            for cell in range(self.logic.num_cells):
                view = self.logic._views.get(cell)
                if view is not None:
                    view.set_db_mode(enabled)
                    if self.backend != "pyqtgraph":
                        self.cell_canvases[cell].draw_idle()

        # browse dialogs --------------------------------------------------- #
        def browse_dataset(self):
            path = QtWidgets.QFileDialog.getExistingDirectory(
                self, "Select Dataset Directory"
            )
            if path:
                n = self.logic.browse_dataset(path)
                self.slider.setMaximum(max(n - 1, 0))
                self.frame = 0

        def browse_config(self):
            path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, "Select Radar Config", filter="Radar config (*.cfg)"
            )
            if path:
                self.logic.browse_config(path)

        def browse_params(self):
            path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, "Select Processor Params",
                filter="YAML (*.yaml *.yml)"
            )
            if path:
                self.logic.browse_processor_params(path)

        def export_movie(self):
            path, _ = QtWidgets.QFileDialog.getSaveFileName(
                self, "Export Dataset Movie", "movie.mp4"
            )
            if path:
                from mmwave_radar_processing_tpu_torch.visualization.video_exporter import (
                    VideoExporter,
                )

                keys = [k for k in self.logic.panel.assignments if k]
                VideoExporter(controller, view_keys=keys).export(path)

    return MainWindow()


def run_qt_viewer(controller, view_keys: Optional[List[str]] = None,
                  interval_ms: int = 50, backend: str = "matplotlib"):
    """Open the viewer window and start the Qt event loop.

    Playback ticks a ``QTimer`` every ``interval_ms`` (50 ms: 20 frames/s).
    """
    from PyQt6 import QtWidgets

    app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
    win = build_main_window(controller, view_keys, interval_ms, backend)
    win.resize(1200, 900)
    win.show()
    app.exec()
