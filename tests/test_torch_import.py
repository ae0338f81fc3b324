"""The PyTorch port imports and runs without JAX, and never falls back silently."""

import os
import subprocess
import sys

import pytest
import torch

from mmwave_radar_processing_tpu_torch import (
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
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
import mmwave_radar_processing_tpu_torch.ops.beamform
import mmwave_radar_processing_tpu_torch.ops.kernels.beamform
import mmwave_radar_processing_tpu_torch.ops.kernels.doppler_az
import mmwave_radar_processing_tpu_torch.ops.peaks
import mmwave_radar_processing_tpu_torch.ops.ransac
import mmwave_radar_processing_tpu_torch.parallel.capon_pipeline
import mmwave_radar_processing_tpu_torch.processors.base
import mmwave_radar_processing_tpu_torch.processors.beamforming
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
print("OK", int(out.count[0]))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _JAX_FREE_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK ")


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
