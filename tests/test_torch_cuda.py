"""Tests of the port that need a CUDA device: the hand-written kernel has no CPU mode.

They carry the ``cuda`` marker and skip where ``torch.cuda.is_available()``
is False.  This file imports no JAX, so it also runs on a GPU machine without
JAX, where ``tests/conftest.py`` (which imports JAX) cannot load:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import build_point_cloud_pipeline, load_cfg
from mmwave_radar_processing_tpu_torch.ops import cfar
from mmwave_radar_processing_tpu_torch.ops.kernels import os_cfar as kernel

pytestmark = pytest.mark.cuda

FLAGSHIP = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
SECOND = dict(num_train=(4, 6), num_guard=(2, 1), rho=0.5, alpha=3.0)
CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "6843_RadVel_ods_20Hz.cfg")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _quantized_maps(shape, seed, device):
    rng = np.random.default_rng(seed)
    x = np.round(rng.exponential(1.0, shape) * 8) / 8
    return torch.from_numpy(x.astype(np.float32)).to(device)


@pytest.mark.parametrize("params", [FLAGSHIP, SECOND], ids=["flagship", "second"])
@pytest.mark.parametrize("shape", [(1, 63, 70), (64, 63, 70), (3, 17, 15),
                                   (2, 10, 12), (5, 64, 128), (2, 256, 192)])
def test_kernel_equals_plain_version(cuda, params, shape):
    x = _quantized_maps(shape, seed=shape[0], device=cuda)
    before = kernel.os_cfar_2d_detect.launches
    got = cfar.os_2d_detect(x, **params)
    torch.cuda.synchronize()
    assert kernel.os_cfar_2d_detect.launches == before + 1
    assert torch.equal(got, cfar.os_2d_detect_reference(x, **params))


def test_pipeline_on_cuda_matches_cpu_and_launches_the_kernel(cuda):
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    rng = np.random.default_rng(0)
    raw = [torch.from_numpy(rng.standard_normal((4, 4, 63, 210)).astype(np.float32))
           for _ in "ri"]
    kernel.os_cfar_2d_detect.launches = 0
    got = build_point_cloud_pipeline(cfg, device=cuda)(*(r.to(cuda) for r in raw))
    torch.cuda.synchronize()
    assert kernel.os_cfar_2d_detect.launches == 1
    want = build_point_cloud_pipeline(cfg, device="cpu")(*raw)
    assert torch.equal(got.count.cpu(), want.count)
    assert torch.equal(got.valid.cpu(), want.valid)
    torch.testing.assert_close(got.points.cpu(), want.points, rtol=0, atol=1e-5)
