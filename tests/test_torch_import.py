"""The PyTorch port imports and runs without JAX, and never falls back silently."""

import os
import subprocess
import sys

import pytest
import torch

from mmwave_radar_processing_tpu_torch import build_point_cloud_pipeline

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
