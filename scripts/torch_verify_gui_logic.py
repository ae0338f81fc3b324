#!/usr/bin/env python
"""Manual Qt harness: drive the port's viewer window through its behaviours (twin of ``verify_gui_logic.py``).

The interactive counterpart of the headless tests
(``tests/test_torch_views.py``).  Builds a simulated dataset, opens the
real ``MainWindow`` (the matplotlib tier, or ``--backend pyqtgraph``) over
a controller on ``--device`` (default cuda; the CPU only when asked for),
then scripts a pass over the live widgets:

1. per-cell view selection and uniqueness (selecting a view that another
   cell shows clears that cell);
2. hidden-view payload caching, drawn on reveal;
3. the dB toggle's re-render;
4. a short timed playback.

Needs PyQt6 (and a display, or ``QT_QPA_PLATFORM=offscreen``); without it,
it says so and exits 0.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--backend", choices=["matplotlib", "pyqtgraph"], default="matplotlib")
    p.add_argument("--device", default="cuda",
                   help="torch device of the controller (default cuda; cpu only when asked for)")
    args = p.parse_args()

    try:
        from PyQt6 import QtCore, QtWidgets
    except ImportError:
        print("PyQt6 not installed: this manual harness needs a Qt environment; "
              "the same behaviours run headless in tests/test_torch_views.py")
        return 0

    import numpy as np

    from mmwave_radar_processing_tpu_torch.visualization.qt_shell import build_main_window
    from scripts.torch_measure_playback_rate import build_controller

    with tempfile.TemporaryDirectory() as td:
        ctl, _ = build_controller(td, 8, args.device)
        app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
        win = build_main_window(
            ctl, view_keys=["range_doppler_resp", "range_resp", None, None],
            backend=args.backend)
        win.resize(1200, 900)
        win.show()
        app.processEvents()

        logic = win.logic

        # 1. uniqueness: cell 0's view selected in cell 1 clears cell 0
        key0 = logic.panel.assignments[0]
        combo1 = win.cell_combos[1]
        combo1.setCurrentIndex(combo1.findData(key0))
        app.processEvents()
        assert logic.panel.assignments[1] == key0, "cell 1 selection failed"
        assert logic.panel.assignments[0] is None, "uniqueness not enforced"
        print("[ok] per-cell uniqueness")

        # 2. hidden-view caching: a payload of an unselected view is cached,
        # then drawn when the view is revealed
        hidden = next(k for k in logic.options
                      if k and k not in logic.panel.assignments)
        payload = {"data": np.random.default_rng(0).random((10, 12)) + 0.1,
                   "vel_bins": np.arange(12), "time_bins": np.arange(10)}
        assert logic.on_view_update(hidden, payload) == []
        combo2 = win.cell_combos[2]
        combo2.setCurrentIndex(combo2.findData(hidden))
        app.processEvents()
        assert logic._views[2].latest_payload is not None, "reveal render"
        print("[ok] hidden-view caching and render on reveal")

        # 3. the dB toggle re-renders every live cell
        win.db_box.setChecked(False)
        app.processEvents()
        win.db_box.setChecked(True)
        app.processEvents()
        print("[ok] dB toggle")

        # 4. timed playback: the 50 ms tick for 2 s, then close
        win.toggle_play()
        QtCore.QTimer.singleShot(2000, app.quit)
        app.exec()
        print(f"[ok] playback ticked to frame {win.frame} (backend={args.backend})")
        win.close()
    print("torch_verify_gui_logic: ALL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
