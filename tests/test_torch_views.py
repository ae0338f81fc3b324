"""The port's viewer drawing side (views, shell logic, video exporter, pyqtgraph tier, Qt shell) against the JAX package's, on the CPU.

- The same numpy payload into a JAX view and a port view: the drawn arrays
  (``AxesImage.get_array()``, extents, line data, scatter offsets and
  colours) are bit-equal, in dB and linear mode.
- The JAX view tests run on the port's views: dB toggling, colormaps, the
  zoomed-bin precedence of the Doppler-azimuth view, redraw stability (no
  artist leaks, the cached colorbars of the point-cloud views).
- Payloads of the JAX controller and the port's (``device="cpu"``) over a
  3-frame simulated recording under the shipped YAML, drawn by each
  package's views: linear images and curves at rtol 1e-4 and atol 1e-4 of
  the maximum, dB within 0.1 dB wherever the linear value is at least 1e-2
  of the maximum, detection markers identical, points within 1e-5.
- ``ShellLogic``'s selection, uniqueness, hidden-view caching, fan-out and
  browse actions, the JAX tests' cases, on both packages alike.
- ``export_movie(path, plotter)`` writes as many frames as the JAX
  ``VideoExporter(controller).export(path)`` (the JAX method itself raises
  ``TypeError`` for any plotter object: a defect of the reference package,
  left unedited).
- The pyqtgraph tier through ``tests/pg_shim.py``: each Pg view of the port
  receives what JAX's receives.
"""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
import yaml

import mmwave_radar_processing_tpu.visualization as jviz
import mmwave_radar_processing_tpu_torch.visualization as tviz
from mmwave_radar_processing_tpu.visualization import shell_logic as jshell
from mmwave_radar_processing_tpu.visualization import views as jviews
from mmwave_radar_processing_tpu_torch import load_cfg
from mmwave_radar_processing_tpu_torch.data import (
    PointTarget, Scene, make_odom_rows, simulate_frame, write_dataset,
)
from mmwave_radar_processing_tpu_torch.visualization import shell_logic as tshell
from mmwave_radar_processing_tpu_torch.visualization import views as tviews

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(REPO, "configs", "6843_RadVel_ods_20Hz.cfg")
#: the controller comparison's frames and their odometry (both sides of the DBS gate)
VELOCITIES = ((0.3, 0.0, 0.1), (0.5, 0.2, 0.0), (0.05, 0.05, 0.0))
RTOL, ATOL_OF_MAX, DB_TOL, DB_FLOOR, POINTS_ATOL = 1e-4, 1e-4, 0.1, 1e-2, 1e-5


def _db(x):
    return 20.0 * np.log10(np.maximum(np.abs(x), 1e-12))


def drawn(ax):
    """What an Axes shows: images, lines, scatter collections and texts, as host arrays."""
    return {
        "images": [(np.ma.getdata(im.get_array()).copy(), np.ma.getmaskarray(im.get_array()),
                    tuple(im.get_extent()), im.get_cmap().name) for im in ax.images],
        "lines": [(np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float),
                   ln.get_linestyle(), ln.get_label()) for ln in ax.lines],
        "collections": [(np.asarray(c.get_offsets()), None if c.get_array() is None
                         else np.ma.getdata(c.get_array()).copy(),
                         getattr(c, "_offsets3d", None)) for c in ax.collections],
        "texts": [ax.get_title(), ax.get_xlabel(), ax.get_ylabel()],
    }


def assert_drawn_equal(got, want):
    """Bit-equal drawings (NaN where NaN)."""
    assert got["texts"] == want["texts"]
    for part in ("images", "lines", "collections"):
        assert len(got[part]) == len(want[part]), part
        for g, w in zip(got[part], want[part]):
            for a, b in zip(g, w):
                if isinstance(b, np.ndarray) or (isinstance(b, tuple) and b
                                                 and isinstance(b[0], np.ndarray)):
                    np.testing.assert_array_equal(np.asarray(a, float), np.asarray(b, float))
                else:
                    assert a == b


def _map_close(got, want, db, what):
    """A drawn map (image or curve) at the controller bars: linear at rtol/atol of the max; dB within 0.1 dB above the floor."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, what
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    if not finite.any():
        return
    if db:
        strong = finite & (want >= want[finite].max() + _db(DB_FLOOR))
        np.testing.assert_allclose(got[strong], want[strong], rtol=0, atol=DB_TOL, err_msg=what)
    else:
        scale = np.abs(want[finite]).max()
        np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL,
                                   atol=ATOL_OF_MAX * scale, err_msg=what)


def assert_drawn_close(got, want, db, what, points=False):
    """Two drawings of payloads of the two packages at the controller bars."""
    assert got["texts"] == want["texts"], what
    for (g, gm, ge, gc), (w, wm, we, wc) in zip(got["images"], want["images"]):
        _map_close(np.where(gm, np.nan, g), np.where(wm, np.nan, w), db, what)
        np.testing.assert_allclose(ge, we, rtol=0, atol=1e-6, err_msg=what)
        assert gc == wc
    assert len(got["images"]) == len(want["images"]), what
    assert len(got["lines"]) == len(want["lines"]), what
    for (gx, gy, gs, gl), (wx, wy, ws, wl) in zip(got["lines"], want["lines"]):
        np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-6, err_msg=what)
        if gl.startswith("altitude"):
            assert gs == ws
            continue
        _map_close(gy, wy, db, what)
        assert (gs, gl) == (ws, wl), what
    assert len(got["collections"]) == len(want["collections"]), what
    for (go, ga, _), (wo, wa, _) in zip(got["collections"], want["collections"]):
        if points:  # the cloud's (y, x) and velocity colours
            np.testing.assert_allclose(go, wo, rtol=0, atol=POINTS_ATOL, err_msg=what)
            np.testing.assert_allclose(ga, wa, rtol=0, atol=POINTS_ATOL, err_msg=what)
        else:  # detection markers: at bin positions, over a drawn curve or a map
            np.testing.assert_array_equal(go[:, 0], wo[:, 0], err_msg=what)
            if not np.array_equal(go[:, 1], wo[:, 1]):
                _map_close(go[:, 1], wo[:, 1], db, what)


def payload(view_key, i=0, seed=13):
    """A numpy payload of ``view_key``'s contract (the JAX redraw test's payloads)."""
    rng = np.random.default_rng(seed + i)
    two_d = rng.random((12, 18)) + 0.1
    prof = rng.random(64) + 0.1
    pts = np.column_stack([rng.random((20, 3)), np.linspace(-1, 1, 20)])
    thr = np.full(64, 0.5)
    thr[:5] = np.inf
    return {
        "range_angle": {"data": two_d, "range_bins": np.linspace(0, 5, 12),
                        "angle_bins": np.linspace(-1, 1, 18)},
        "micro_doppler": {"data": two_d, "vel_bins": np.linspace(-5, 5, 12),
                          "time_bins": np.linspace(0, 2, 18)},
        "doppler_azimuth": {"data": two_d, "vel_bins": np.linspace(-5, 5, 12),
                            "valid_angle_bins": np.linspace(-1, 1, 18),
                            "zoomed_vel_bins": np.linspace(-0.3, 0.3, 12) if i % 2 else None},
        "range_doppler": {"data": two_d, "range_bins": np.linspace(0, 5, 12),
                          "vel_bins": np.linspace(-2, 2, 18)},
        "range_response": {"data": prof, "range_bins": np.linspace(0, 4, 64)},
        "range_doppler_detector": {"data": np.array([[3, 4], [7, 10 + i % 3]]),
                                   "rng_dop_resp": two_d, "range_bins": np.linspace(0, 5, 12),
                                   "vel_bins": np.linspace(-2, 2, 18)},
        "range_detector": {"data": np.array([10, 20 + i % 5]), "range_resp": prof,
                           "thresholds": thr, "range_bins": np.linspace(0, 4, 64)},
        "altitude": {"data": np.array(1.0 + 0.01 * i), "coarse_fft_data": prof,
                     "range_bins": np.linspace(0, 4, 64)},
        "point_cloud": {"data": pts},
        "point_cloud_3d": {"data": pts},
    }[view_key]


@pytest.fixture()
def close_figures():
    yield
    plt.close("all")


def test_view_registry_equals_jax():
    assert list(tviews.VIEW_CLASSES) == list(jviews.VIEW_CLASSES)
    for name, cls in tviews.VIEW_CLASSES.items():
        assert cls.__name__ == jviews.VIEW_CLASSES[name].__name__
        assert cls.__module__.startswith("mmwave_radar_processing_tpu_torch.")


@pytest.mark.parametrize("db_mode", [True, False], ids=["db", "linear"])
@pytest.mark.parametrize("view_key", list(jviews.VIEW_CLASSES))
def test_same_payload_draws_the_same(view_key, db_mode, close_figures):
    """The same payload into a JAX view and a port view, three frames: bit-equal drawings."""
    fig, (ax_j, ax_t) = plt.subplots(1, 2)
    jv = jviews.VIEW_CLASSES[view_key](ax=ax_j, db_mode=db_mode)
    tv = tviews.VIEW_CLASSES[view_key](ax=ax_t, db_mode=db_mode)
    for i in range(3):
        p = payload(view_key, i)
        jv.set_data(p)
        tv.set_data(p)
        assert tv.latest_payload is p
        assert_drawn_equal(drawn(tv.ax), drawn(jv.ax))
    # a re-render of the cached payload in the other mode, and another colormap
    for view in (jv, tv):
        view.set_db_mode(not db_mode)
        view.set_colormap("magma")
    assert_drawn_equal(drawn(tv.ax), drawn(jv.ax))


@pytest.mark.parametrize("view_key", list(tviews.VIEW_CLASSES))
def test_view_redraw_stability(view_key, close_figures):
    """The JAX redraw test on the port: 100 redraws leak no artist and keep the axes' size (one cached colorbar)."""
    fig, ax = plt.subplots()
    view = tviews.VIEW_CLASSES[view_key](ax=ax)

    def count(f):
        return len(f.axes) + sum(len(a.images) + len(a.lines) + len(a.collections)
                                 + len(a.texts) for a in f.axes)
    for i in range(5):
        view.set_data(payload(view_key, i))
    count5, pos5 = count(view.ax.figure), view.ax.get_position().bounds
    for i in range(5, 100):
        view.set_data(payload(view_key, i))
    assert count(view.ax.figure) == count5
    assert view.ax.get_position().bounds == pytest.approx(pos5)


def test_doppler_azimuth_zoomed_bins_precedence(close_figures):
    """The JAX test's case: the zoomed grid sets the rows' extent when it has one entry a row."""
    view = tviews.DopplerAzimuthView(ax=plt.subplots()[1], db_mode=False)
    data = np.random.default_rng(2).random((15, 25))
    base = {"data": data, "vel_bins": np.linspace(-5, 5, 15),
            "valid_angle_bins": np.linspace(-1, 1, 25)}
    view.set_data(base)
    np.testing.assert_array_equal(view.ax.images[-1].get_array(), data)
    zoomed = np.linspace(-0.3, 0.3, 15)
    view.set_data(dict(base, zoomed_vel_bins=zoomed))
    assert view.ax.images[-1].get_extent()[2] == pytest.approx(zoomed[0])
    view.set_data(dict(base, zoomed_vel_bins=zoomed[:7]))
    assert view.ax.images[-1].get_extent()[2] == pytest.approx(-5.0)


def test_point_cloud_3d_view_replaces_a_2d_axes(close_figures):
    """The JAX test's case: a 2D axes handed in becomes a 3D one; the colours clip to the window."""
    view = tviews.PointCloud3DView(ax=plt.subplots()[1], min_vel=-0.25, max_vel=0.25)
    assert view.ax.name == "3d"
    pts = payload("point_cloud_3d")["data"]
    view.set_data({"data": pts})
    sc = view.ax.collections[-1]
    assert sc.get_clim() == (-0.25, 0.25)
    assert np.max(np.asarray(sc.get_array())) <= 0.25
    assert view._colorbar.ax.get_ylabel() == "Velocity (m/s)"
    view.set_data(pts)  # the points as the payload itself
    view.set_data({"data": np.empty((0, 4))})


# --- controller payloads of both packages, drawn ---------------------------- #
@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A 3-frame recording with odometry, its dataset YAML and the shipped processor YAML."""
    root = tmp_path_factory.mktemp("views")
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    rng = np.random.default_rng(0)
    frames = []
    for i in range(len(VELOCITIES)):
        scene = Scene(targets=[PointTarget(range_m=0.5 + 0.05 * i, rcs=4.0),
                               PointTarget(range_m=1.5, azimuth_rad=0.3, velocity_m_s=0.5,
                                           rcs=3.0)], noise_sigma=0.04)
        frames.append(simulate_frame(cfg, scene, rng))
    write_dataset(str(root / "rec"), np.stack(frames),
                  odom=np.stack([make_odom_rows(np.array(v)) for v in VELOCITIES]))
    ds = {"dataset": {"dataset_path": str(root / "rec"), "radar_adc_folder": "radar_0_adc",
                      "vehicle_odom_folder": "vehicle_odom"},
          "config": {"name": CFG_PATH, "array_geometry": "ods", "array_direction": "down"}}
    (root / "dataset_params.yaml").write_text(yaml.safe_dump(ds))
    return {"root": str(root), "rec": str(root / "rec"),
            "dataset": str(root / "dataset_params.yaml"),
            "processors": os.path.join(REPO, "gui_configs", "processor_params.yaml")}


def controller(module, recording, **kw):
    return module.MmWaveRadarProcessorController(
        registry=module.get_default_registry(), dataset_params_path=recording["dataset"],
        processor_params_path=recording["processors"], **kw)


@pytest.fixture(scope="module")
def played(recording):
    """Every key's payloads over the recording, from each package's controller."""
    out = {}
    for name, ctl in (("jax", controller(jviz, recording)),
                      ("port", controller(tviz, recording, device="cpu"))):
        store = {}
        ctl.subscribe_view_update(lambda k, p, s=store: s.setdefault(k, []).append(p))
        ctl.play()
        out[name] = store
    assert set(out["jax"]) == set(out["port"]) and len(out["jax"]) == 14
    return out


@pytest.mark.parametrize("key", list(jviz.get_default_registry()))
def test_controller_payloads_draw_alike(played, key, close_figures):
    """Each key's payloads of the two controllers, drawn by each package's view, linear and dB, frame by frame."""
    view_name = jviz.get_default_registry()[key].view_name
    fig, (ax_j, ax_t) = plt.subplots(1, 2)
    jv = jviews.VIEW_CLASSES[view_name](ax=ax_j, db_mode=False)
    tv = tviews.VIEW_CLASSES[view_name](ax=ax_t, db_mode=False)
    for i, (pj, pt) in enumerate(zip(played["jax"][key], played["port"][key])):
        for db in (False, True):
            jv.set_db_mode(db)
            tv.set_db_mode(db)
            jv.set_data(pj)
            tv.set_data(pt)
            assert_drawn_close(drawn(tv.ax), drawn(jv.ax), db, f"{key} frame {i} db={db}",
                               points=view_name == "point_cloud")


def test_export_movie_writes_the_frames_of_jax_default_export(recording, played, tmp_path):
    """The port's ``export_movie(path, plotter)`` against the JAX exporter with its default views; the JAX method's defect."""
    from mmwave_radar_processing_tpu.visualization.video_exporter import VideoExporter

    jctl = controller(jviz, recording)
    tctl = controller(tviz, recording, device="cpu")
    want = VideoExporter(jctl).export(str(tmp_path / "jax.mp4"))
    got = tctl.export_movie(str(tmp_path / "port.mp4"), plotter=object(), fps=5)
    assert got == want == len(VELOCITIES)
    assert tctl._view_subscribers == []  # the exporter unsubscribed
    files = sorted(os.listdir(tmp_path))
    assert any(f.startswith("port.") for f in files) and any(f.startswith("jax.") for f in files)
    # the reference method hands the plotter to VideoExporter as its view keys
    with pytest.raises(TypeError):
        jctl.export_movie(str(tmp_path / "jax_method.mp4"), plotter=object())


def test_exporter_hands_the_views_the_controller_payloads(recording, played):
    """``frame_payloads`` yields, for each frame, the payloads the controller emitted for the exporter's keys."""
    from mmwave_radar_processing_tpu_torch.visualization.video_exporter import VideoExporter

    tctl = controller(tviz, recording, device="cpu")
    exporter = VideoExporter(tctl)
    assert exporter.view_keys == list(tctl.processors)[:4]
    stream = list(exporter.frame_payloads())
    assert [i for i, _ in stream] == list(range(len(VELOCITIES)))
    for i, payloads in stream:
        assert list(payloads) == exporter.view_keys
        for key, p in payloads.items():
            want = played["port"][key][i]
            assert set(p) == set(want)
            np.testing.assert_array_equal(p["data"], want["data"])


# --- ShellLogic, the JAX tests' cases on both packages ---------------------- #
class _MockController:
    """A registry of view names and the view-update subscription, all ShellLogic reads."""

    def __init__(self, registry):
        self.registry = registry
        self.subscribers = []

    def subscribe_view_update(self, fn):
        self.subscribers.append(fn)


SELECTIONS = {
    "uniqueness": [(0, "range_doppler_resp"), (3, "range_doppler_resp")],
    "clear_then_reuse": [(1, None), (2, "range_resp"), (1, "range_resp"), (2, None)],
    "every_cell": [(c, k) for c, k in enumerate(("micro_doppler_resp", "altimeter",
                                                  "capon_beamformer", "range_detector"))],
    "same_cell_twice": [(0, "range_angle_resp"), (0, "range_angle_resp"), (0, None)],
}


@pytest.mark.parametrize("case", list(SELECTIONS))
def test_shell_selection_equals_jax(case):
    """The same selections on both packages' ShellLogic: assignments, changed cells, options."""
    logics = [m.ShellLogic(_MockController(r.get_default_registry()), num_cells=4,
                           initial_keys=["range_doppler_resp", "range_resp", None, None])
              for m, r in ((jshell, jviz), (tshell, tviz))]
    assert logics[0].options == logics[1].options
    for cell, key in SELECTIONS[case]:
        changed = [logic.select_view(cell, key) for logic in logics]
        assert changed[0] == changed[1]
        assert logics[0].panel.assignments == logics[1].panel.assignments
    assert sum(k is not None and logics[1].panel.assignments.count(k) > 1
               for k in logics[1].panel.assignments) == 0


def test_shell_default_keys_equal_jax():
    got = tshell.ShellLogic(_MockController(tviz.get_default_registry()))
    want = jshell.ShellLogic(_MockController(jviz.get_default_registry()))
    assert got.panel.assignments == want.panel.assignments


def test_shell_hidden_view_caching(close_figures):
    """A payload of an unselected view is cached, not drawn; revealing the view draws it at once."""
    ctl = _MockController(tviz.get_default_registry())
    logic = tshell.ShellLogic(ctl, num_cells=4,
                              initial_keys=["range_doppler_resp", "range_resp", None, None])
    assert ctl.subscribers == [logic.on_view_update]
    rendered = []
    logic.set_render_callback(rendered.append)
    p = {"data": np.random.default_rng(0).random((10, 12)) + 0.1,
         "vel_bins": np.arange(12), "time_bins": np.arange(10)}
    assert logic.on_view_update("micro_doppler_resp", p) == []
    assert logic.panel.latest_payloads["micro_doppler_resp"] is p and rendered == []
    view = logic.view_class_for("micro_doppler_resp")(ax=plt.subplots()[1])
    logic.bind_cell_view(2, view)
    logic.select_view(2, "micro_doppler_resp")
    assert view.latest_payload is p and rendered == [2]
    assert isinstance(view, tviews.MicroDopplerView)


def test_shell_fanout_and_browse_actions(recording, tmp_path, close_figures):
    """Browse a dataset and a config, load a parameter YAML, and draw a frame of the fan-out (the JAX tests' cases)."""
    registry = tviz.get_default_registry()
    for key, spec in registry.items():
        spec.enabled = key in {"range_doppler_resp", "range_resp", "micro_doppler_resp"}
    ctl = tviz.MmWaveRadarProcessorController(registry=registry, device="cpu")
    logic = tshell.ShellLogic(ctl, num_cells=4,
                              initial_keys=["range_doppler_resp", "range_resp", None, None])
    assert logic.browse_dataset(recording["rec"]) == len(VELOCITIES)
    logic.browse_config(CFG_PATH, "ods", "down")
    assert set(ctl.processors) == {"range_doppler_resp", "range_resp", "micro_doppler_resp"}
    view = logic.view_class_for("range_doppler_resp")(ax=plt.subplots()[1])
    logic.bind_cell_view(0, view)
    ctl.process_next_frame(0)
    assert view.latest_payload is not None and view.ax.images
    params = tmp_path / "pp.yaml"
    params.write_text(yaml.safe_dump({"processors": {"range_doppler_resp": {"rx_idx": 0}}}))
    logic.browse_processor_params(str(params))
    assert ctl.processor_params == {"range_doppler_resp": {"rx_idx": 0}}
    assert "range_doppler_resp" in ctl.processors


def test_qt_main_window_offscreen(recording):
    pytest.importorskip("PyQt6")
    os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
    from PyQt6.QtWidgets import QApplication

    from mmwave_radar_processing_tpu_torch.visualization.qt_shell import build_main_window

    app = QApplication.instance() or QApplication([])
    ctl = controller(tviz, recording, device="cpu")
    win = build_main_window(ctl, view_keys=["range_doppler_resp", "range_resp"])
    assert len(win.cell_combos) == 4
    combo = win.cell_combos[2]
    combo.setCurrentIndex(combo.findData("micro_doppler_resp"))
    assert win.logic.panel.assignments[2] == "micro_doppler_resp"
    win.close()
    del app


# --- the pyqtgraph tier through the fake-module shim ------------------------ #
def _pg_state(view):
    """What a Pg view handed to pyqtgraph: image, rect, levels, LUT, curves, markers, line, scatter, title."""
    state = {}
    for name in ("image", "curve", "thr_curve", "markers", "marker", "scatter"):
        item = getattr(view, name, None)
        if item is not None:
            state[name] = {k: v for k, v in vars(item).items()
                           if isinstance(v, (np.ndarray, float, int, bool, str, type(None)))}
            rect = getattr(item, "rect", None)
            if rect is not None:
                state[name]["rect"] = (rect.x(), rect.y(), rect.width(), rect.height())
    if hasattr(view, "plot"):
        state["title"] = getattr(view.plot, "title", None)
    return state


def _assert_pg_equal(got, want):
    assert set(got) == set(want)
    for name, fields in want.items():
        if not isinstance(fields, dict):
            assert got[name] == fields
            continue
        assert set(got[name]) == set(fields), name
        for k, v in fields.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[name][k], v, err_msg=f"{name}.{k}")
            else:
                assert got[name][k] == v, f"{name}.{k}"


@pytest.fixture()
def pg_classes(monkeypatch):
    import pg_shim

    pg_shim.install(monkeypatch)
    from mmwave_radar_processing_tpu.visualization import pyqtgraph_views as jpg
    from mmwave_radar_processing_tpu_torch.visualization import pyqtgraph_views as tpg

    assert tpg.pyqtgraph_available()
    return jpg.get_pg_view_classes(), tpg.get_pg_view_classes()


def test_pg_registry_covers_the_matplotlib_views(pg_classes):
    jpg, tpg = pg_classes
    assert list(tpg) == list(jpg) and set(tpg) == set(tviews.VIEW_CLASSES)


@pytest.mark.parametrize("view_key", list(jviews.VIEW_CLASSES))
def test_pg_views_receive_what_jax_receives(pg_classes, view_key):
    """The same payloads into each package's Pg view, dB and linear: the shim records equal calls."""
    jpg, tpg = pg_classes
    kw = {"min_vel": -0.5, "max_vel": 1.5} if view_key.startswith("point_cloud") else {}
    for db in (True, False):
        jv, tv = jpg[view_key](db_mode=db, **kw), tpg[view_key](db_mode=db, **kw)
        for i in range(3):
            p = payload(view_key, i)
            jv.set_data(p)
            tv.set_data(p)
            assert tv.latest_payload is p
            _assert_pg_equal(_pg_state(tv), _pg_state(jv))
        jv.set_db_mode(not db)
        tv.set_db_mode(not db)
        _assert_pg_equal(_pg_state(tv), _pg_state(jv))
    if view_key.startswith("point_cloud"):
        for name in ("_cb_img", "_cb_plot"):
            got, want = vars(getattr(tv, name)), vars(getattr(jv, name))
            assert set(got) == set(want)
        np.testing.assert_array_equal(tv._cb_img.image, jv._cb_img.image)
        assert tv._cb_plot.y_range == jv._cb_plot.y_range == pytest.approx((-0.5, 1.5))


def test_pg_tier_without_pyqtgraph_raises_import_error(monkeypatch):
    import sys

    from mmwave_radar_processing_tpu_torch.visualization import pyqtgraph_views as tpg

    monkeypatch.setitem(sys.modules, "pyqtgraph", None)
    assert not tpg.pyqtgraph_available()
    with pytest.raises(ImportError):
        tpg.get_pg_view_classes()
