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
    build_point_cloud_pipeline,
    build_velocity_pipeline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_FREE_RUN = """
import sys
sys.modules["jax"] = None  # any import of jax now fails, even a preloaded one
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
# every module of the port, found by walking the package
import importlib, pkgutil
walked = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in walked:
    importlib.import_module(name)
assert len(walked) >= 35, walked
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
    """A grep of the port, ``chip_smoke.py`` and the stage scripts for an import of JAX or the JAX package."""
    sources = glob.glob(os.path.join(REPO, "mmwave_radar_processing_tpu_torch", "**", "*.py"),
                        recursive=True)
    sources += [os.path.join(REPO, name) for name in
                ("chip_smoke.py", "torch_pointcloud_stages.py", "torch_velocity_stages.py")]
    assert len(sources) >= 40
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
