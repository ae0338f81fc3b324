#!/usr/bin/env python
"""Manual Qt harness: per-cell view uniqueness with mock views (twin of ``verify_unique_view.py``).

Exercises the port's selection and uniqueness logic (``ShellLogic``)
against a live widget tree with light mock views and a mock controller (no
processor, no dataset, so no device), so that the combo wiring itself is
under test.  Its Qt-free core runs headless in ``tests/test_torch_views.py``.
Needs PyQt6 (and a display, or ``QT_QPA_PLATFORM=offscreen``); without it,
it says so and exits 0.  With PyQt6 it leaves the window open until it is
closed, unless ``--no-wait``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

#: mock processor keys and the registry view each one is drawn by
MOCK_KEYS = {"view1": "range_doppler", "view2": "range_response",
             "range_doppler_resp": "range_doppler", "range_angle_resp": "range_angle",
             "range_resp": "range_response", "doppler_azimuth_resp": "doppler_azimuth"}


class MockController:
    """Just enough controller for ``ShellLogic``: a registry of view names and the view-update subscription."""

    class _Dataset:
        num_frames = 0

    dataset_model = _Dataset()

    def __init__(self, keys):
        self.registry = {k: type("Spec", (), {"enabled": True, "view_name": view})()
                         for k, view in keys.items()}
        self._subs = []

    def subscribe_view_update(self, fn):
        self._subs.append(fn)


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--no-wait", action="store_true",
                   help="close the window after the scripted check")
    args = p.parse_args()

    try:
        from PyQt6 import QtWidgets
    except ImportError:
        print("PyQt6 not installed: this manual harness needs a Qt environment; "
              "the uniqueness rule runs headless in tests/test_torch_views.py")
        return 0

    from mmwave_radar_processing_tpu_torch.visualization.shell_logic import ShellLogic

    class MockView(QtWidgets.QWidget):
        def __init__(self, parent=None):
            super().__init__(parent)
            lay = QtWidgets.QVBoxLayout(self)
            lay.addWidget(QtWidgets.QLabel("I am a plot", self))
            self.latest_payload = None

        def set_data(self, payload):
            self.latest_payload = payload

        def set_db_mode(self, enabled):
            pass

    app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
    logic = ShellLogic(MockController(MOCK_KEYS), num_cells=4,
                       initial_keys=["range_doppler_resp", None, None, None])
    win = QtWidgets.QMainWindow()
    central = QtWidgets.QWidget()
    grid = QtWidgets.QGridLayout(central)
    combos = []
    for cell in range(4):
        box = QtWidgets.QVBoxLayout()
        combo = QtWidgets.QComboBox()
        for key in logic.options:
            combo.addItem(key or "(none)", key)
        view = MockView()
        box.addWidget(combo)
        box.addWidget(view)
        w = QtWidgets.QWidget()
        w.setLayout(box)
        grid.addWidget(w, cell // 2, cell % 2)
        combos.append(combo)
        logic.bind_cell_view(cell, view)

        def on_change(_i, c=cell, cb=combo):
            for changed in logic.select_view(c, cb.currentData()):
                if changed != c:
                    combos[changed].blockSignals(True)
                    combos[changed].setCurrentIndex(
                        combos[changed].findData(logic.panel.assignments[changed]))
                    combos[changed].blockSignals(False)

        combo.currentIndexChanged.connect(on_change)
        combo.blockSignals(True)
        combo.setCurrentIndex(combo.findData(logic.panel.assignments[cell]))
        combo.blockSignals(False)

    win.setCentralWidget(central)
    win.resize(800, 600)
    win.show()
    app.processEvents()

    # the scripted check: cell 0's view selected in cell 1 clears cell 0
    combos[1].setCurrentIndex(combos[1].findData("range_doppler_resp"))
    app.processEvents()
    assert logic.panel.assignments[1] == "range_doppler_resp"
    assert logic.panel.assignments[0] is None
    assert combos[0].currentData() is None
    print("torch_verify_unique_view: uniqueness OK")
    if not args.no_wait:
        app.exec()
    win.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
