"""The PyTorch port imports and runs without JAX or the JAX package, and never falls back silently."""

import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from mmwave_radar_processing_tpu_torch import (
    Altimeter,
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
    PointCloudGenerator,
    RangeDetector,
    RangeDopplerDetector2D,
    RangeDopplerDetectorSequential,
    RangeDopplerGroundDetector,
    RangeDopplerProcessor,
    RangeProcessor,
    VirtualArrayReformatter,
    build_capon_pipeline,
    build_full_pipeline,
    build_ground_point_cloud_pipeline,
    build_point_cloud_pipeline,
    build_velocity_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel import (
    build_dbs_pipeline,
    build_micro_doppler_pipeline,
    build_spectral_maps_pipeline,
    build_strip_map_pipeline,
    build_synthetic_aperture_pipeline,
)
from mmwave_radar_processing_tpu_torch.point_cloud_processing import (
    VehicleVelEstimator,
    VelocityEstimator as PointsVelocityEstimator,
)
from mmwave_radar_processing_tpu_torch.processors import (
    DopplerAzimuthProcessor,
    MicroDopplerProcessor,
    RangeAngleProcessor,
    RangeAngleProcessorDBSEnhanced,
    StripMapSARProcessor,
    SyntheticArrayBeamformerProcessor,
    VelocityEstimator,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_FREE_RUN = """
import sys
sys.modules["jax"] = None  # any import of jax now fails, even a preloaded one
# the card's host is not known to have these: nothing may import them at module level
for name in ("yaml", "pandas", "imageio", "matplotlib", "PyQt6", "pyqtgraph"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
import mmwave_radar_processing_tpu_torch as port

cfg = port.load_cfg("configs/6843_RadVel_ods_20Hz.cfg", array_geometry="ods",
                    array_direction="down")
raw_re, raw_im, _ = port.make_inputs(cfg, 1, seed=7)
out = port.build_point_cloud_pipeline(cfg, device="cpu")(
    torch.from_numpy(raw_re), torch.from_numpy(raw_im))
assert out.points.shape == (1, 128, 4) and out.valid.shape == (1, 128)
assert int(out.count[0]) > 0 and bool(torch.isfinite(out.points).all())
alt = torch.full((1,), 1.2)
for precise in (False, True):
    vel = port.build_velocity_pipeline(cfg, enable_precise=precise, device="cpu")(
        torch.from_numpy(raw_re), torch.from_numpy(raw_im), alt)
    assert vel.velocity.shape == (1, 3) and bool(torch.isfinite(vel.velocity).all())
pc, vel = port.build_full_pipeline(cfg, device="cpu")(
    torch.from_numpy(raw_re), torch.from_numpy(raw_im), alt)
assert torch.equal(pc.count, out.count) and vel.vx.shape == (1,)
re_t, im_t = torch.from_numpy(raw_re), torch.from_numpy(raw_im)
for method in ("capon", "bartlett"):
    heat = port.build_capon_pipeline(cfg, method=method, device="cpu")(re_t, im_t)
    assert heat.shape == (1, 63, 64) and bool(torch.isfinite(heat).all())
from mmwave_radar_processing_tpu_torch.processors.virtual_array import reformat
virt = reformat(torch.complex(re_t, im_t), num_rx=4, cfgs_per_loop=3)[0]
for cls in (port.BartlettBeamformerProcessor, port.CaponBeamformerProcessor):
    proc = cls(cfg, device="cpu")
    assert proc.process(virt).shape == (63, 64)
    assert proc.azimuth_elevation_heatmap(virt, 20).shape == (64, 32)
# the detector API: one frame through each entry point
det = port.get_detector_registry()["os_cfar_2d"](
    num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0, device="cpu")
rd_map = port.RangeDopplerProcessor(cfg, device="cpu").process(virt, rx_idx=0)
assert len(det.detect(rd_map)) > 0
assert port.VirtualArrayReformatter(cfg, device="cpu").process(
    torch.complex(re_t, im_t))[0].shape == virt.shape
assert port.RangeProcessor(cfg, device="cpu").process(virt).shape == (63,)
alt = port.Altimeter(cfg, 0.25, 0.2, 1.5, device="cpu")
assert 0.5 < float(alt.process(virt)) < 2.0
assert len(port.RangeDetector(cfg, device="cpu").process(virt)) > 0
for name, cls in port.get_range_doppler_detector_registry().items():
    assert cls(cfg, device="cpu").process(virt).shape[1] == 2, name
for aoa in ("fft", "capon"):
    pts = port.PointCloudGenerator(cfg, [0, 3, 4, 7], [9, 8, 5, 4], aoa_method=aoa,
                                   device="cpu").process(virt)
    assert pts.shape[1] == 4 and len(pts) > 0
# the ground scan and the velocity object API
ground = port.build_ground_point_cloud_pipeline(cfg, device="cpu")(re_t, im_t)
assert ground.points.shape == (1, 128, 4) and ground.altitude.shape == (1,)
assert bool(torch.isfinite(ground.points).all()) and ground.final_altitude.shape == ()
from mmwave_radar_processing_tpu_torch.processors import VelocityEstimator
est = VelocityEstimator(cfg, 0.5, 0.5, device="cpu")
for precise in (False, True):
    v = est.process(adc_cube=virt, altitude=1.2, enable_precise_responses=precise)
    assert v.shape == (3,) and bool(np.isfinite(v).all())
from mmwave_radar_processing_tpu_torch.point_cloud_processing import (
    VehicleVelEstimator, VelocityEstimator as PointsVE)
cloud = pts.astype(np.float64)
assert PointsVE(cfg, device="cpu").process(points=cloud).shape == (3,)
VehicleVelEstimator(device="cpu").estimate_ego_vel(cloud)
# the spectral-map family: processors on one frame, the builders on the batch
assert port.RangeAngleProcessor(cfg, device="cpu").process(virt).shape == (63, 64)
md = port.MicroDopplerProcessor(cfg, device="cpu")
assert md.process(virt).shape == (70, 20) and md.scan(virt[None])[1].shape == (1, 70, 20)
assert port.StripMapSARProcessor(cfg, device="cpu").process(
    torch.complex(re_t, im_t)[0], vel_m_per_s=0.25).size > 0
dbs = port.RangeAngleProcessorDBSEnhanced(cfg, device="cpu")
assert dbs.process(virt, velocity_ned=[0.5, 0.2, 0.0]).shape == (63, 64)
sa = port.SyntheticArrayBeamformerProcessor(cfg, device="cpu")
assert sa.process(torch.complex(re_t, im_t)[0], current_vel=[0.2, 0.0, 0.0]).shape == (0,)
maps = port.build_spectral_maps_pipeline(cfg, device="cpu")(re_t, im_t)
assert maps.range_angle.shape == (1, 63, 64) and bool(torch.isfinite(maps.doppler_azimuth).all())
assert port.build_micro_doppler_pipeline(cfg, device="cpu")(re_t, im_t).shape == (1, 70, 20)
assert port.build_strip_map_pipeline(cfg, device="cpu")(re_t, im_t).shape == (1, 63, 70)
assert port.build_dbs_pipeline(cfg, device="cpu")(
    re_t, im_t, torch.tensor([[0.5, 0.2, 0.0]])).shape == (1, 63, 100)
mag, ok = port.build_synthetic_aperture_pipeline(cfg, device="cpu")(
    re_t, im_t, torch.tensor([[0.2, 0.0, 0.0]]))
assert mag.shape == (1, 63, 60, 1) and not bool(ok[0])
# every module of the port, found by walking the package
import importlib, pkgutil
walked = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in walked:
    importlib.import_module(name)
assert len(walked) >= 84, walked
assert {"mmwave_radar_processing_tpu_torch.parallel." + name for name in (
    "launch", "mesh", "collectives", "halo_cfar", "overlap_save", "sharded_beamform",
    "input_feed", "scaling", "dryrun", "rank_checks")} <= set(walked)
assert "mmwave_radar_processing_tpu_torch.ops.zoom_fir" in walked
from mmwave_radar_processing_tpu_torch.parallel import (
    build_sharded_zoom_fir, make_mesh, shard_pipeline)
assert {"mmwave_radar_processing_tpu_torch.parallel.viewer_pipeline",
        "mmwave_radar_processing_tpu_torch.visualization.controller",
        "mmwave_radar_processing_tpu_torch.visualization.precompute",
        "mmwave_radar_processing_tpu_torch.visualization.processor_registry",
        "mmwave_radar_processing_tpu_torch.visualization.view_panel"} <= set(walked)
# the drawing side: every module imports with matplotlib, imageio, yaml and Qt blocked
assert {"mmwave_radar_processing_tpu_torch.visualization." + name for name in (
    "views", "shell_logic", "video_exporter", "pyqtgraph_views", "qt_shell")} | {
    "mmwave_radar_processing_tpu_torch.plotting." + name for name in (
        "plotter_mmwave_data", "plotter_odometry", "plotter_synthetic_array",
        "analysis_plotter", "movie_generator")} <= set(walked)
from mmwave_radar_processing_tpu_torch.plotting import MovieGeneratorOdometry
# the viewer's backend: the payload pipeline on the batch, the controller's registry
from mmwave_radar_processing_tpu_torch.parallel import build_viewer_payload_pipeline
payload = build_viewer_payload_pipeline(cfg, cfar_type="os_cfar_2d", cfar_params=dict(
    num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0), device="cpu")(re_t, im_t)
assert torch.equal(payload["det_count"], out.count)
from mmwave_radar_processing_tpu_torch.visualization import get_default_registry
assert len(get_default_registry()) == 14
# the recording path's host layer, and the scripts that drive it (top level only)
import runpy, glob
scripts = sorted(glob.glob("scripts/torch_*.py"))
assert len(scripts) == 12, scripts
for path in scripts + ["bench_torch.py"]:
    runpy.run_path(path, run_name="imported")
# the verify leg against the committed JAX oracle, and the detector twin, with JAX blocked
from mmwave_radar_processing_tpu_torch.utils import roofline, verify
report = verify.run_verify(["pointcloud_f32", "capon"], 32, device="cpu")
assert report["ok"] and report["device"] == "cpu", report
assert roofline.analytic_cost("pointcloud", cfg).flops_per_frame > 0
twin = runpy.run_path("scripts/torch_verify_detectors.py", run_name="imported")
assert all(row["ok"] for row in twin["run"]("cpu"))
from mmwave_radar_processing_tpu_torch.analysis import VelocityAnalyzer
analyzer = VelocityAnalyzer()
analyzer.analyze(np.ones((3, 3)), np.zeros((3, 3)))
assert analyzer.compute_summary_statistics(analyzer.get_norm_errors())["Mean"] > 1.7
from mmwave_radar_processing_tpu_torch.utils.checkpoint import flatten
assert flatten({"b": 1, "a": (2, None)}) == [2, 1]
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
jax_package = sorted(m for m in sys.modules if m == "mmwave_radar_processing_tpu"
                     or m.startswith("mmwave_radar_processing_tpu."))
assert jax_package == [], jax_package
print("OK", int(out.count[0]))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _JAX_FREE_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK ")


def test_no_source_of_the_port_imports_the_jax_package():
    """A grep of the port, ``chip_smoke.py``, ``bench_torch.py`` and ``scripts/torch_*.py`` for an import of JAX or the JAX package."""
    sources = glob.glob(os.path.join(REPO, "mmwave_radar_processing_tpu_torch", "**", "*.py"),
                        recursive=True)
    sources += [os.path.join(REPO, name) for name in ("chip_smoke.py", "bench_torch.py")]
    sources += glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))
    assert len(sources) >= 70
    banned = re.compile(r"^\s*(from|import)\s+(jax|mmwave_radar_processing_tpu)(\.|\s|$)",
                        re.MULTILINE)
    for path in sources:
        with open(path) as fh:
            found = banned.search(fh.read())
        assert found is None, f"{os.path.relpath(path, REPO)}: {found.group(0).strip()}"
    assert banned.search("from mmwave_radar_processing_tpu.config import grids")
    assert banned.search("    import jax") and banned.search("import jax.numpy as jnp")
    assert not banned.search("from mmwave_radar_processing_tpu_torch.config import grids")


def test_cuda_request_raises_without_a_gpu(flagship_config):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_point_cloud_pipeline(flagship_config, device="cuda")


def test_device_is_required(flagship_config):
    with pytest.raises(TypeError):
        build_point_cloud_pipeline(flagship_config)  # no implicit default device


@pytest.mark.parametrize("build", [build_velocity_pipeline, build_full_pipeline],
                         ids=lambda f: f.__name__)
def test_device_is_required_for_velocity(flagship_config, build):
    with pytest.raises(TypeError):
        build(flagship_config)


@pytest.mark.parametrize("build", [build_velocity_pipeline, build_full_pipeline],
                         ids=lambda f: f.__name__)
def test_cuda_request_raises_without_a_gpu_for_velocity(flagship_config, build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(flagship_config, device="cuda")


@pytest.mark.parametrize("build", [build_capon_pipeline, BartlettBeamformerProcessor,
                                   CaponBeamformerProcessor], ids=lambda f: f.__name__)
def test_cuda_request_raises_without_a_gpu_for_beamforming(flagship_config, build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(flagship_config, device="cuda")


DETECTOR_API = {
    "VirtualArrayReformatter": lambda cfg, **kw: VirtualArrayReformatter(cfg, **kw),
    "RangeProcessor": lambda cfg, **kw: RangeProcessor(cfg, **kw),
    "RangeDopplerProcessor": lambda cfg, **kw: RangeDopplerProcessor(cfg, **kw),
    "Altimeter": lambda cfg, **kw: Altimeter(cfg, 0.25, 0.2, 0.4, **kw),
    "RangeDetector": lambda cfg, **kw: RangeDetector(cfg, **kw),
    "RangeDopplerDetector2D": lambda cfg, **kw: RangeDopplerDetector2D(cfg, **kw),
    "RangeDopplerDetectorSequential": lambda cfg, **kw: RangeDopplerDetectorSequential(cfg, **kw),
    "RangeDopplerGroundDetector": lambda cfg, **kw: RangeDopplerGroundDetector(cfg, **kw),
    "PointCloudGenerator": lambda cfg, **kw: PointCloudGenerator(
        cfg, [0, 3, 4, 7], [9, 8, 5, 4], **kw),
    "build_ground_point_cloud_pipeline": lambda cfg, **kw: build_ground_point_cloud_pipeline(
        cfg, **kw).rng_dft,
    "DopplerAzimuthProcessor": lambda cfg, **kw: DopplerAzimuthProcessor(cfg, **kw),
    "VelocityEstimator": lambda cfg, **kw: VelocityEstimator(cfg, 0.5, 0.5, **kw),
    "PointsVelocityEstimator": lambda cfg, **kw: PointsVelocityEstimator(cfg, **kw),
    "VehicleVelEstimator": lambda cfg, **kw: VehicleVelEstimator(**kw),
}

SPECTRAL_API = {
    "RangeAngleProcessor": lambda cfg, **kw: RangeAngleProcessor(cfg, **kw),
    "MicroDopplerProcessor": lambda cfg, **kw: MicroDopplerProcessor(cfg, **kw),
    "StripMapSARProcessor": lambda cfg, **kw: StripMapSARProcessor(cfg, **kw),
    "RangeAngleProcessorDBSEnhanced": lambda cfg, **kw: RangeAngleProcessorDBSEnhanced(cfg, **kw),
    "SyntheticArrayBeamformerProcessor": lambda cfg, **kw: SyntheticArrayBeamformerProcessor(
        cfg, **kw),
    "build_spectral_maps_pipeline": lambda cfg, **kw: build_spectral_maps_pipeline(
        cfg, **kw).rd_rng,
    "build_micro_doppler_pipeline": lambda cfg, **kw: build_micro_doppler_pipeline(
        cfg, **kw).rng,
    "build_strip_map_pipeline": lambda cfg, **kw: build_strip_map_pipeline(cfg, **kw).rng,
    "build_dbs_pipeline": lambda cfg, **kw: build_dbs_pipeline(cfg, **kw).rng,
    "build_synthetic_aperture_pipeline": lambda cfg, **kw: build_synthetic_aperture_pipeline(
        cfg, **kw).rng_dft,
}


@pytest.mark.parametrize("name", list(DETECTOR_API))
def test_detector_api_needs_a_device_and_raises_without_a_gpu(flagship_config, name):
    with pytest.raises(TypeError):
        DETECTOR_API[name](flagship_config)  # no implicit default device
    assert DETECTOR_API[name](flagship_config, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DETECTOR_API[name](flagship_config, device="cuda")


@pytest.mark.parametrize("name", list(SPECTRAL_API))
def test_spectral_api_needs_a_device_and_raises_without_a_gpu(flagship_config, name):
    with pytest.raises(TypeError):
        SPECTRAL_API[name](flagship_config)  # no implicit default device
    assert SPECTRAL_API[name](flagship_config, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SPECTRAL_API[name](flagship_config, device="cuda")


def test_no_module_of_the_port_imports_yaml_pandas_or_imageio_at_top_level():
    """A grep of the port and ``chip_smoke.py``: those imports, and matplotlib's and Qt's, sit inside functions only."""
    sources = glob.glob(os.path.join(REPO, "mmwave_radar_processing_tpu_torch", "**", "*.py"),
                        recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    top_level = re.compile(r"^(from|import)\s+(yaml|pandas|imageio|matplotlib|PyQt6|pyqtgraph)"
                           r"(\.|\s|$)", re.MULTILINE)
    for path in sources:
        with open(path) as fh:
            found = top_level.search(fh.read())
        assert found is None, f"{os.path.relpath(path, REPO)}: {found.group(0).strip()}"
    assert top_level.search("import pandas as pd") and not top_level.search("    import yaml")
    assert top_level.search("from PyQt6 import QtCore") and top_level.search("import matplotlib")


@pytest.mark.parametrize("script", ["torch_process_recording.py", "torch_simulate_dataset.py",
                                    "torch_test_vel_estimation.py",
                                    "torch_test_multi_vel_estimation.py",
                                    "torch_verify_detectors.py",
                                    "torch_launch_mmwave_viewer.py", "torch_view_radar_data.py",
                                    "torch_doppler_beam_sharpening_demo.py",
                                    "torch_measure_playback_rate.py",
                                    "torch_verify_gui_logic.py", "torch_verify_unique_view.py",
                                    "torch_measure_angle_accuracy.py"])
def test_scripts_of_the_port_import_no_jax(script):
    """Each ``scripts/torch_*.py`` answers ``--help`` with JAX, the JAX package, yaml, matplotlib and Qt blocked."""
    blocked = ("import sys, runpy; "
               "[sys.modules.__setitem__(m, None) for m in ('jax', 'yaml', 'pandas', 'imageio', "
               "'matplotlib', 'PyQt6', 'pyqtgraph', 'mmwave_radar_processing_tpu')]; "
               f"sys.argv = ['{script}', '--help']; "
               f"runpy.run_path('scripts/{script}', run_name='__main__')")
    if script.endswith("vel_estimation.py"):  # yaml is imported in main, after the arguments
        blocked = blocked.replace("'yaml', ", "")
    proc = subprocess.run([sys.executable, "-c", blocked], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage" in proc.stdout


@pytest.mark.parametrize("name", ["process_recording", "analyze_velocity"])
def test_recording_api_needs_a_device_and_raises_without_a_gpu(flagship_config, tmp_path, name):
    from mmwave_radar_processing_tpu_torch.analysis import analyze_velocity
    from mmwave_radar_processing_tpu_torch.data import CpslDS
    from mmwave_radar_processing_tpu_torch.parallel.recording import process_recording

    calls = {"process_recording": lambda **kw: process_recording(["x.npy"], flagship_config,
                                                                  mode="points", **kw),
             "analyze_velocity": lambda **kw: analyze_velocity(
                 CpslDS(str(tmp_path)), flagship_config,
                 {"processors": {"point_cloud_generator": {
                     "az_antenna_idxs": [0, 3, 4, 7], "el_antenna_idxs": [9, 8, 5, 4]}}}, **kw)}
    with pytest.raises(TypeError):
        calls[name]()  # no implicit default device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name](device="cuda")


def test_bench_torch_imports_no_jax():
    """``bench_torch.py --help`` with JAX, the JAX package, yaml, pandas and imageio blocked."""
    blocked = ("import sys, runpy; "
               "[sys.modules.__setitem__(m, None) for m in ('jax', 'yaml', 'pandas', 'imageio', "
               "'mmwave_radar_processing_tpu')]; "
               "sys.argv = ['bench_torch.py', '--help']; "
               "runpy.run_path('bench_torch.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", blocked], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage" in proc.stdout and "--verify" in proc.stdout
