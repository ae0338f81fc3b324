"""The port's drawing scripts against the JAX package's scripts, on the CPU.

Each ``scripts/torch_*.py`` twin of a drawing script runs with ``--device
cpu`` on a 6-frame simulated recording, beside the JAX script
(``JAX_PLATFORMS=cpu``), all at once:

- ``torch_view_radar_data.py`` and ``torch_doppler_beam_sharpening_demo.py``
  write PNGs of the JAX scripts' size, on which at most 1% of the pixels
  differ (the data agree within float32 rounding; a colour may fall into
  the neighbouring colormap bin);
- ``torch_launch_mmwave_viewer.py --export-movie`` writes as many frames as
  the JAX script, each of the same size;
- ``torch_measure_playback_rate.py`` prints the JAX script's keys, with the
  device beside them;
- the Qt harnesses exit 0 with the JAX scripts' message where PyQt6 is absent;
- ``torch_measure_angle_accuracy.py``'s planted frames equal JAX's
  ``make_truth_frames`` bit for bit, and its statistics at 8 frames equal
  those of JAX's ``f32`` point-cloud pipeline;
- ``torch_test_vel_estimation.py --plot-out`` writes the summary figure.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml
from PIL import Image

from mmwave_radar_processing_tpu_torch import load_cfg
from mmwave_radar_processing_tpu_torch.data import (
    PointTarget, Scene, ground_scene, make_odom_rows, simulate_frame, write_dataset,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(REPO, "configs", "6843_RadVel_ods_20Hz.cfg")
FRAMES = 6
EGO = (0.3, 0.05, 0.0)
MAX_PIXEL_SHARE = 0.01
QT_MESSAGE = "PyQt6 not installed"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """Six ground frames with a moving target, odometry beside them; the dataset YAML."""
    root = tmp_path_factory.mktemp("drawing_scripts")
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    rng = np.random.default_rng(4)
    frames = []
    for i in range(FRAMES):
        scene = ground_scene(cfg, altitude_m=0.6 + 0.05 * i, ego_vel=np.array(EGO),
                             num_patches=120, rng=rng, noise_sigma=0.02)
        scene = Scene(targets=list(scene.targets) + [
            PointTarget(range_m=1.5, azimuth_rad=0.3, velocity_m_s=0.5, rcs=3.0)],
            noise_sigma=scene.noise_sigma)
        frames.append(simulate_frame(cfg, scene, rng))
    rec = str(root / "rec")
    write_dataset(rec, np.stack(frames), odom=np.stack([make_odom_rows(EGO)] * FRAMES))
    ds = {"dataset": {"dataset_path": rec, "radar_adc_folder": "radar_0_adc",
                      "vehicle_odom_folder": "vehicle_odom"},
          "config": {"name": CFG_PATH, "array_geometry": "ods", "array_direction": "down"}}
    (root / "dataset_params.yaml").write_text(yaml.safe_dump(ds))
    return {"root": root, "rec": rec, "dataset_params": str(root / "dataset_params.yaml")}


#: scripts run at once, each on one thread: the suite's other workers time things
WAVE = 6


def _start(script, *args, port):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", MPLBACKEND="Agg",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("QT_QPA_PLATFORM", None)
    cmd = [sys.executable, os.path.join(REPO, "scripts", script), *args]
    if port:
        cmd += ["--device", "cpu"]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(recording):
    """Every pair of scripts (JAX, port), all started at once: ``{name: (jax, port)}`` outputs."""
    root = recording["root"]
    pairs = {
        "view_radar_data": lambda tag: [
            "--dataset", recording["rec"], "--frame", "2", "--out", str(root / f"view_{tag}.png")],
        "doppler_beam_sharpening_demo": lambda tag: [
            "--out", str(root / f"dbs_{tag}.png")],
        "launch_mmwave_viewer": lambda tag: [
            "--dataset-params", recording["dataset_params"],
            "--processor-params", os.path.join(REPO, "gui_configs", "processor_params.yaml"),
            "--export-movie", str(root / f"viewer_{tag}.mp4"), "--frames", "3"],
        "measure_playback_rate": lambda tag: [
            "--frames", "2", "--build-frames", "2", "--only-selected"],
        "verify_gui_logic": lambda tag: [],
        "verify_unique_view": lambda tag: [],
    }
    jobs = [(name, f"{prefix}{name}.py", args(tag), port)
            for name, args in pairs.items()
            for prefix, tag, port in (("", "jax", False),
                                      # the unique-view harness runs no processor
                                      ("torch_", "port", name != "verify_unique_view"))]
    texts = {}
    for first in range(0, len(jobs), WAVE):
        wave = [(job, _start(job[1], *job[2], port=job[3])) for job in jobs[first:first + WAVE]]
        for (name, script, _, _), proc in wave:
            text, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, (script, text[-3000:])
            texts[script] = text
    return {name: (texts[f"{name}.py"], texts[f"torch_{name}.py"]) for name in pairs}


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"), np.int16)


@pytest.mark.parametrize("name,stem", [("view_radar_data", "view"),
                                       ("doppler_beam_sharpening_demo", "dbs")])
def test_figure_scripts_draw_what_jax_draws(runs, recording, name, stem):
    got, want = (_pixels(recording["root"] / f"{stem}_{tag}.png") for tag in ("port", "jax"))
    assert got.shape == want.shape
    differ = (np.abs(got - want).max(-1) > 0).mean()
    assert differ <= MAX_PIXEL_SHARE, differ
    assert (want != 255).any()  # not a blank figure


def test_viewer_export_writes_the_frames_jax_writes(runs, recording):
    sizes = {}
    for tag in ("jax", "port"):
        (path,) = [p for p in os.listdir(recording["root"]) if p.startswith(f"viewer_{tag}.")]
        with Image.open(recording["root"] / path) as im:
            sizes[tag] = (path.split(".")[-1], im.n_frames, im.size)
    assert sizes["port"] == sizes["jax"]
    assert sizes["port"][1] == 3


def test_playback_rate_prints_the_jax_keys(runs):
    want, got = (json.loads(text.strip().splitlines()[-1]) for text in runs["measure_playback_rate"])
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu" and got["cells"] == want["cells"] == 4
    assert got["frames"] == want["frames"] == 2 and got["fps"] > 0


@pytest.mark.parametrize("name", ["verify_gui_logic", "verify_unique_view"])
def test_qt_harnesses_without_qt(runs, name):
    try:
        import PyQt6  # noqa: F401
        pytest.skip("PyQt6 is installed: the harness opens a window")
    except ImportError:
        pass
    want, got = runs[name]
    assert QT_MESSAGE in want and QT_MESSAGE in got


def test_angle_accuracy_truth_frames_equal_jax(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    jax_script = _load("scripts/measure_angle_accuracy.py", "jax_measure_angle_accuracy")
    twin = _load("scripts/torch_measure_angle_accuracy.py", "torch_measure_angle_accuracy")
    assert (twin.N_FRAMES, twin.SEED) == (jax_script.N_FRAMES, jax_script.SEED) == (256, 99)
    monkeypatch.setattr(jax_script, "N_FRAMES", 4)
    _, jre, jim, jtruth = jax_script.make_truth_frames()
    _, tre, tim, ttruth = twin.make_truth_frames(4)
    for got, want in ((tre, jre), (tim, jim), (ttruth, jtruth)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_angle_accuracy_statistics_equal_jax_f32(monkeypatch, tmp_path):
    """At 8 frames: the twin's statistics on the CPU against JAX's ``f32`` pipeline's and the JAX script's matching."""
    from bench import AZ_IDXS, CFAR_PARAMS, EL_IDXS, _flagship_config
    from mmwave_radar_processing_tpu.parallel.pipeline import build_point_cloud_pipeline

    monkeypatch.syspath_prepend(REPO)
    jax_script = _load("scripts/measure_angle_accuracy.py", "jax_measure_angle_accuracy")
    twin = _load("scripts/torch_measure_angle_accuracy.py", "torch_measure_angle_accuracy")
    cfg, re, im, truths = twin.make_truth_frames(8)
    out = build_point_cloud_pipeline(
        _flagship_config(), az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
        cfar_params=CFAR_PARAMS, max_dets=128, backend="mxu", aoa_precision="f32")(re, im)
    errs = jax_script.angle_errors(np.asarray(out.points), np.asarray(out.valid), truths)

    report = twin.measure("cpu", 8)
    stats = report["devices"]["cpu"]
    assert stats["n_matched"] == errs.size > 0
    assert stats["rmse_deg"] == pytest.approx(np.rad2deg(np.sqrt(np.mean(errs ** 2))), abs=1e-3)
    assert stats["p90_abs_deg"] == pytest.approx(
        np.rad2deg(np.quantile(np.abs(errs), 0.9)), abs=1e-3)
    assert stats["max_abs_deg"] == pytest.approx(np.rad2deg(np.max(np.abs(errs))), abs=1e-3)
    assert report["frames_matched_on_both"] == errs.size and report["apart_share"] == 0.0

    # the script itself writes its report where --out says, never to the JAX report
    path = tmp_path / "angle.json"
    proc = subprocess.run([sys.executable, "scripts/torch_measure_angle_accuracy.py",
                           "--device", "cpu", "--frames", "4", "--out", str(path)],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    written = json.loads(path.read_text())
    assert written["n_frames"] == 4 and set(written["devices"]) == {"cpu"}


def test_vel_estimation_plot_out_writes_the_summary_figure(recording, tmp_path):
    out = tmp_path / "summary.png"
    proc = subprocess.run([sys.executable, "scripts/torch_test_vel_estimation.py",
                           "--dataset", recording["rec"], "--device", "cpu",
                           "--plot-out", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO, MPLBACKEND="Agg"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "velocity error report" in proc.stdout
    with Image.open(out) as im:
        assert im.size == (1000, 800)  # the 10 x 8 in summary at dpi 100
