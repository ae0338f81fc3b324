"""The port's viewer backend (registry, controller, precompute) against the JAX package's, on the CPU.

One simulated CPSL recording of 5 frames with odometry (its speeds straddle
the DBS gate), written by the port's ``write_dataset``, is played by the JAX
controller and by the port's (``device="cpu"``) for the same YAML files:
the shipped ``gui_configs/processor_params.yaml`` and a full-coverage set
(``chip_smoke.VIEWER_PARAMS_FULL``).  Bars, port against JAX: maps within
rtol 1e-5 and 1e-5 of the maximum (the Capon map: rtol 1e-4 and 1e-4 of the
maximum, the bar of the Capon processor since it was ported, as a float32
inverse of a loaded covariance rounds apart at the 4e-5 level); detection
sets identical; points within 1e-5; thresholds with identical finite masks
and rtol 1e-5 where finite; bins equal.  The port's precompute against its
own per-frame path is held to the JAX package's rule
(``tests/test_visualization.py:248-290``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import mmwave_radar_processing_tpu.visualization as jviz
import mmwave_radar_processing_tpu_torch.visualization as tviz
from mmwave_radar_processing_tpu.visualization import precompute as jpre
from mmwave_radar_processing_tpu_torch import load_cfg
from mmwave_radar_processing_tpu_torch.data import (
    PointTarget, Scene, make_odom_rows, simulate_frame, write_dataset,
)
from mmwave_radar_processing_tpu_torch.visualization import (
    MmWaveRadarProcessorController,
    get_default_registry,
    mmWaveRadarProcessorController,
)
from mmwave_radar_processing_tpu_torch.visualization import precompute
from mmwave_radar_processing_tpu_torch.visualization.view_panel import ViewPanelModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(REPO, "configs", "6843_RadVel_ods_20Hz.cfg")
SHIPPED_YAML = os.path.join(REPO, "gui_configs", "processor_params.yaml")
#: per-frame odometry velocities: |v_xy| on both sides of the 0.25 m/s DBS gate
VELOCITIES = ((0.3, 0.0, 0.1), (0.1, 0.0, 0.0), (0.5, 0.2, 0.0), (0.05, 0.05, 0.0),
              (0.8, -0.3, 0.0))
RTOL, ATOL_OF_MAX, POINTS_ATOL = 1e-5, 1e-5, 1e-5
CAPON_RTOL = 1e-4
PARAM_SETS = ("shipped", "full")


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """The recording, its dataset YAML and one processor YAML per parameter set."""
    root = tmp_path_factory.mktemp("viewer")
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    rng = np.random.default_rng(0)
    frames, odom = [], []
    for i, vel in enumerate(VELOCITIES):
        alt = 0.5 + 0.05 * i
        scene = Scene(targets=[PointTarget(range_m=alt, rcs=4.0),
                               PointTarget(range_m=1.5, azimuth_rad=0.3, velocity_m_s=0.5,
                                           rcs=3.0)], noise_sigma=0.04)
        frames.append(simulate_frame(cfg, scene, rng))
        odom.append(make_odom_rows(np.array(vel)))
    write_dataset(str(root / "rec"), np.stack(frames), odom=np.stack(odom))
    ds = {"dataset": {"dataset_path": str(root / "rec"), "radar_adc_folder": "radar_0_adc",
                      "vehicle_odom_folder": "vehicle_odom"},
          "config": {"name": CFG_PATH, "array_geometry": "ods", "array_direction": "down"}}
    paths = {"dataset": str(root / "dataset_params.yaml")}
    (root / "dataset_params.yaml").write_text(yaml.safe_dump(ds))
    for name, params in chip_smoke.VIEWER_PARAM_SETS.items():
        (root / f"{name}.yaml").write_text(yaml.safe_dump({"processors": params}))
        paths[name] = str(root / f"{name}.yaml")
    return paths


def controller(module, ds_path, pp_path, *, keep=None, **kw):
    registry = module.get_default_registry()
    if keep is not None:
        for key, spec in registry.items():
            spec.enabled = key in keep
    return module.MmWaveRadarProcessorController(
        registry=registry, dataset_params_path=ds_path, processor_params_path=pp_path, **kw)


def play(ctl, cache=False):
    """``(payloads by key, covered keys)`` of a whole playback."""
    covered = ctl.enable_precomputed_playback() if cache else None
    store = {}
    ctl.subscribe_view_update(lambda k, p: store.setdefault(k, []).append(p))
    ctl.play()
    return store, covered


@pytest.fixture(scope="module")
def runs(recording):
    """Playbacks by (package, parameter set, cache), each made once."""
    made = {}

    def get(package, name, cache):
        key = (package, name, cache)
        if key not in made:
            if package == "jax":
                ctl = controller(jviz, recording["dataset"], recording[name])
            else:
                ctl = controller(tviz, recording["dataset"], recording[name],
                                 device="cpu")
            made[key] = play(ctl, cache)
        return made[key]
    return get


def assert_payload(key, attr, got, want, frame):
    msg = f"{key}.{attr} frame {frame}"
    if want is None:
        assert got is None, msg
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=msg)
        return
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=msg)
    if not finite.any():
        return
    if key == "point_cloud_generator":
        np.testing.assert_allclose(got, want, rtol=0, atol=POINTS_ATOL, err_msg=msg)
        return
    rtol = CAPON_RTOL if key == "capon_beamformer" else RTOL
    scale = float(np.max(np.abs(want[finite])))
    atol = (CAPON_RTOL if key == "capon_beamformer" else ATOL_OF_MAX) * scale
    if attr == "thresholds":
        atol = 0.0
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol, err_msg=msg)


def assert_equal_to_jax(got, want):
    assert set(got) == set(want)
    for key in want:
        assert len(got[key]) == len(want[key]) == len(VELOCITIES), key
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            assert set(g) == set(w), (key, sorted(g), sorted(w))
            for attr in w:
                assert_payload(key, attr, g[attr], w[attr], i)


def test_registry_rows_equal_jax():
    port, jax_side = get_default_registry(), jviz.get_default_registry()
    assert list(port) == list(jax_side) and len(port) == 14
    for key, spec in port.items():
        want = jax_side[key]
        for field in ("key", "display_name", "view_name", "required_inputs", "output_schema",
                      "enabled", "requires_velocity", "num_frames_history", "view_keys"):
            assert getattr(spec, field) == getattr(want, field), (key, field)
        assert spec.processor_cls.__name__ == want.processor_cls.__name__
        assert spec.processor_cls.__module__.startswith("mmwave_radar_processing_tpu_torch.")
    assert get_default_registry() is not get_default_registry()


@pytest.mark.parametrize("params", PARAM_SETS)
def test_per_frame_payloads_equal_jax(runs, params):
    """Every view's payload on every frame; stateful keys over the whole sequence."""
    got, _ = runs("port", params, False)
    want, _ = runs("jax", params, False)
    assert len(want) == 14
    assert_equal_to_jax(got, want)


@pytest.mark.parametrize("params", PARAM_SETS)
def test_precompute_equals_jax(runs, params):
    """The same covered keys, and the same payloads, from both packages' caches."""
    got, covered = runs("port", params, True)
    want, jax_covered = runs("jax", params, True)
    assert covered == jax_covered
    expected_misses = {"shipped": {"doppler_azimuth_resp", "altimeter", "point_cloud_generator"},
                       "full": set()}[params]
    assert covered == set(jpre.COVERED) - expected_misses
    assert_equal_to_jax(got, want)


@pytest.mark.parametrize("params", PARAM_SETS)
def test_precompute_equals_the_per_frame_path(runs, params):
    """The port's cache against its own per-frame controller, at the JAX package's rule.

    ``chip_smoke.precompute_agrees`` is the rule of
    ``tests/test_visualization.py:248-290``, which the card is held to too.
    """
    ref, _ = runs("port", params, False)
    pre, covered = runs("port", params, True)
    assert covered <= precompute.COVERED
    for key in covered:
        assert len(pre[key]) == len(ref[key]) == len(VELOCITIES), key
    chip_smoke.precompute_agrees(params, ref, pre, covered)


def test_precompute_fallback_for_unsupported_params(recording, tmp_path):
    """YAML params outside the batched pipeline's surface -> the per-frame path."""
    params = dict(chip_smoke.VIEWER_PARAMS_FULL)
    params["doppler_azimuth_resp"] = dict(params["doppler_azimuth_resp"], use_precise_fft=True)
    path = tmp_path / "pp.yaml"
    path.write_text(yaml.safe_dump({"processors": params}))
    ctl = controller(tviz, recording["dataset"], str(path), device="cpu")
    covered = ctl.enable_precomputed_playback()
    assert "doppler_azimuth_resp" not in covered and "range_doppler_resp" in covered
    seen = {}
    ctl.subscribe_view_update(lambda k, p: seen.setdefault(k, []).append(p))
    ctl.process_next_frame(0)
    assert "doppler_azimuth_resp" in seen and "range_doppler_resp" in seen
    assert set(seen) == set(ctl.processors)


def test_precomputed_detector_parity_sequential_and_ground(recording):
    keep = {"range_doppler_detector_sequential", "range_doppler_ground_detector"}
    ref, _ = play(controller(tviz, recording["dataset"], recording["full"],
                             keep=keep, device="cpu"))
    pre, covered = play(controller(tviz, recording["dataset"],
                                   recording["full"], keep=keep, device="cpu"), cache=True)
    assert covered == keep
    for key in keep:
        assert len(ref[key]) == len(pre[key]) == len(VELOCITIES)
        for i in range(len(ref[key])):
            np.testing.assert_array_equal(np.asarray(pre[key][i]["data"]),
                                          np.asarray(ref[key][i]["data"]),
                                          err_msg=f"{key} frame {i}")
            np.testing.assert_allclose(pre[key][i]["rng_dop_resp"], ref[key][i]["rng_dop_resp"],
                                       rtol=2e-4, atol=1e-3)
    assert sum(len(p["data"]) for p in ref["range_doppler_ground_detector"]) > 0


def test_cache_miss_degrades_to_per_frame_recompute(recording, monkeypatch):
    """A covered key whose cached payload misses recomputes on the per-frame path."""
    ref, _ = play(controller(tviz, recording["dataset"], recording["full"],
                             device="cpu"))
    ctl = controller(tviz, recording["dataset"], recording["full"],
                     device="cpu")
    covered = ctl.enable_precomputed_playback()
    missing = "range_doppler_resp"
    assert covered == set(precompute.COVERED)  # every key cached: no frame read up front
    cache = ctl.playback_cache
    real_payload = cache.payload
    monkeypatch.setattr(cache, "payload",
                        lambda k, i: None if k == missing else real_payload(k, i))
    got = {}
    ctl.subscribe_view_update(lambda k, p: got.setdefault(k, []).append(p))
    ctl.process_next_frame(0)
    np.testing.assert_allclose(got[missing][0]["data"], ref[missing][0]["data"],
                               rtol=1e-5, atol=1e-5)
    assert set(got) == set(ref)
    assert len(ctl.adc_buffer) == 1  # read once, for the miss


def test_precomputed_dbs_parity_both_branches(recording):
    """The DBS view's cache equals the per-frame path on both gate branches, bins and mesh with it."""
    keep = {"range_angle_resp_dbs_enhanced"}
    ref, _ = play(controller(tviz, recording["dataset"], recording["full"],
                             keep=keep, device="cpu"))
    pre, covered = play(controller(tviz, recording["dataset"],
                                   recording["full"], keep=keep, device="cpu"), cache=True)
    assert covered == keep
    key = "range_angle_resp_dbs_enhanced"
    for i, v in enumerate(VELOCITIES):
        want, got = np.asarray(ref[key][i]["data"]), np.asarray(pre[key][i]["data"])
        assert want.shape == got.shape == (63, 100 if np.hypot(*v[:2]) >= 0.25 else 64), i
        scale = max(float(np.max(np.abs(want))), 1.0)
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4 * scale, err_msg=f"frame {i}")
        for attr in ("angle_bins", "x_s", "y_s"):
            np.testing.assert_allclose(pre[key][i][attr], ref[key][i][attr], rtol=1e-6)


def test_dbs_falls_back_on_a_dataset_error_only(recording, monkeypatch):
    """Missing odometry drops the DBS key; any other error propagates."""
    keep = {"range_angle_resp_dbs_enhanced", "range_doppler_resp"}

    def build(error):
        ctl = controller(tviz, recording["dataset"], recording["full"],
                         keep=keep, device="cpu")

        def broken(idx):
            raise error

        monkeypatch.setattr(ctl.dataset_model, "get_velocity_ned", broken)
        return ctl

    assert build(OSError("no odometry")).enable_precomputed_playback() == {"range_doppler_resp"}
    with pytest.raises(RuntimeError, match="device fault"):
        build(RuntimeError("device fault")).enable_precomputed_playback()


def test_zero_width_leaf_is_cached_as_zero_width(runs, recording):
    """A valid angle range that holds no angle bin gives ``da_map [B, loops, 0]``.

    The cache copies each leaf on its own, so an empty leaf cannot shift the
    others: every other covered view still equals the per-frame path.  (The
    per-frame Doppler-azimuth processor cannot be built with no valid angle,
    so the range reaches the cache through the controller's parameters.)
    """
    ref, _ = runs("port", "full", False)
    ctl = controller(tviz, recording["dataset"], recording["full"], device="cpu")
    ctl.processor_params = dict(ctl.processor_params)
    ctl.processor_params["doppler_azimuth_resp"] = dict(
        ctl.processor_params["doppler_azimuth_resp"], valid_angle_range=[0.011, 0.012])
    pre, covered = play(ctl, cache=True)
    arrays = ctl.playback_cache._arrays
    assert arrays["da_map"].shape == (len(VELOCITIES), 70, 0)
    assert covered == set(precompute.COVERED)
    for key in covered - {"doppler_azimuth_resp"}:
        for i in range(len(VELOCITIES)):
            for attr, want in ref[key][i].items():
                want, got = np.asarray(want), np.asarray(pre[key][i][attr])
                assert got.shape == want.shape, (key, attr)
                if want.dtype.kind in "biu":
                    np.testing.assert_array_equal(got, want, err_msg=f"{key}.{attr}")
                else:
                    finite = np.isfinite(want)
                    np.testing.assert_array_equal(np.isfinite(got), finite)
                    scale = max(float(np.max(np.abs(want[finite]))), 1.0)
                    np.testing.assert_allclose(got[finite], want[finite], rtol=2e-4,
                                               atol=2e-3 * scale, err_msg=f"{key}.{attr}")


def test_cached_leaves_keep_their_dtypes_and_chunking_changes_nothing(recording):
    """Indices and counts int32, masks bool, maps float32, as the JAX pipeline makes them.

    Chunks of 2, 2 and 1 frames give the same arrays as one chunk of 5.
    """
    def arrays(batch_size):
        ctl = controller(tviz, recording["dataset"], recording["full"], device="cpu")
        ctl.enable_precomputed_playback(batch_size=batch_size)
        return ctl.playback_cache

    whole, chunked = arrays(64), arrays(2)
    assert set(whole.build_split) == {"read_s", "device_s", "copy_s"}
    assert set(whole._arrays) == set(chunked._arrays)
    for name, value in whole._arrays.items():
        assert len(value) == len(VELOCITIES), name
        kind = ("b" if name.endswith(("valid", "_use")) else
                "i" if name.split("_")[-1] in ("r", "v", "idx", "count") else "f")
        assert value.dtype.kind == kind and value.dtype.itemsize in (1, 4), (name, value.dtype)
        np.testing.assert_array_equal(chunked._arrays[name], value, err_msg=name)


def test_the_recording_is_read_bit_equal_to_the_dataset_model(recording):
    """The cache reads the files with the bulk loader: both of its versions equal ``get_adc_data``."""
    from mmwave_radar_processing_tpu_torch.data import native_loader

    ctl = controller(tviz, recording["dataset"], recording["full"], device="cpu")
    ds = ctl.dataset_model
    frames = np.stack([ds.get_adc_data(i) for i in range(ds.num_frames)])
    re, im = precompute.PrecomputedPlayback(ctl)._read_recording(ds, ds.num_frames)
    np.testing.assert_array_equal(re.numpy(), frames.real.astype(np.float32))
    np.testing.assert_array_equal(im.numpy(), frames.imag.astype(np.float32))
    re_n, im_n = native_loader.load_frames_split(ds.get_adc_paths(), frames.shape[1:],
                                                 backend="native")
    assert torch.equal(re_n, re) and torch.equal(im_n, im)


def test_every_processor_takes_extra_yaml_keywords():
    """YAML keywords flow verbatim into every constructor, as in the JAX package; none may break one."""
    params = {key: dict(chip_smoke.VIEWER_PARAMS_FULL.get(key, {}), unused_option=1)
              for key in get_default_registry()}
    ctl = MmWaveRadarProcessorController(device="cpu")
    ctl.load_config(CFG_PATH, array_geometry="ods", array_direction="down")
    ctl.processor_params = params
    ctl.init_processors()
    assert sorted(ctl.processors) == sorted(get_default_registry())


def test_view_panel_model():
    events = []
    panel = ViewPanelModel(num_cells=4, on_assign=lambda c, k: events.append((c, k)))
    assert panel.select(0, "range_doppler") is None
    payload = {"data": 1}
    assert panel.handle_view_update("range_doppler", payload) == [0]
    got = panel.select(2, "range_doppler")
    assert got is payload
    assert panel.assignments[0] is None and panel.assignments[2] == "range_doppler"
    assert (0, None) in events
    panel.handle_view_update("altitude", {"data": 2})
    assert panel.select(1, "altitude") == {"data": 2}
    assert panel.cell_of("altitude") == 1 and panel.cell_of("micro_doppler") is None


def test_controller_defaults_to_cuda():
    assert mmWaveRadarProcessorController is MmWaveRadarProcessorController
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MmWaveRadarProcessorController()


def test_shipped_parameter_set_equals_the_yaml():
    with open(SHIPPED_YAML) as fh:
        assert chip_smoke.VIEWER_PARAMS_SHIPPED == yaml.safe_load(fh)["processors"]


_NO_YAML_RUN = """
import sys
for name in ("yaml", "matplotlib", "PyQt6", "jax", "mmwave_radar_processing_tpu"):
    sys.modules[name] = None
import numpy as np
import mmwave_radar_processing_tpu_torch.visualization as viz
from mmwave_radar_processing_tpu_torch.parallel import viewer_pipeline
from mmwave_radar_processing_tpu_torch.visualization import precompute, view_panel
import chip_smoke
ctl = viz.MmWaveRadarProcessorController(device="cpu")
assert ctl.load_dataset(sys.argv[1]) == 5
ctl.load_config(sys.argv[2], array_geometry="ods", array_direction="down")
ctl.processor_params = chip_smoke.VIEWER_PARAMS_FULL
ctl.init_processors()
assert len(ctl.processors) == 14
assert ctl.enable_precomputed_playback() == set(precompute.COVERED)
seen = {}
ctl.subscribe_view_update(lambda k, p: seen.setdefault(k, p))
ctl.process_next_frame(4)
assert set(seen) == set(ctl.processors)
try:
    ctl.load_defaults("dataset_params.yaml")
except ImportError:
    print("OK")
"""


def test_viewer_imports_and_runs_without_yaml_matplotlib_or_qt(recording):
    rec = os.path.join(os.path.dirname(recording["dataset"]), "rec")
    proc = subprocess.run([sys.executable, "-c", _NO_YAML_RUN, rec, CFG_PATH], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
