"""Tests of the port that need a CUDA device: the hand-written kernels have no CPU mode.

They carry the ``cuda`` marker and skip where ``torch.cuda.is_available()``
is False.  This file imports no JAX, so it also runs on a GPU machine without
JAX, where ``tests/conftest.py`` (which imports JAX) cannot load:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import (
    build_point_cloud_pipeline,
    build_velocity_pipeline,
    load_cfg,
    make_inputs,
)
from mmwave_radar_processing_tpu_torch.ops import cfar, doppler_az
from mmwave_radar_processing_tpu_torch.ops.kernels import doppler_az as dkernel
from mmwave_radar_processing_tpu_torch.ops.kernels import os_cfar as kernel

pytestmark = pytest.mark.cuda

FLAGSHIP = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
SECOND = dict(num_train=(4, 6), num_guard=(2, 1), rho=0.5, alpha=3.0)
CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "6843_RadVel_ods_20Hz.cfg")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
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


# --------------------------------------------------------------------------- #
# the Doppler-azimuth response kernel
# --------------------------------------------------------------------------- #
SETS = ((0, 3, 4, 7), (1, 2, 5, 6), (10, 11, 6, 7), (9, 8, 5, 4))


def _spectra(b, n_ch, w, nv, av, n_cols, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, n_ch, w * nv)),
              rng.standard_normal((b, n_ch, w * nv)),
              rng.uniform(0, 1, (b, w)),
              rng.standard_normal((av, n_cols)),
              rng.standard_normal((av, n_cols)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.parametrize("shape", [(1, 12, 19, 70, 60), (7, 12, 19, 70, 60),
                                   (1024, 12, 19, 70, 60), (3, 12, 19, 140, 60),
                                   (5, 12, 5, 16, 9)],
                         ids=["b1", "b7", "b1024", "zoom", "odd"])
def test_response_kernel_equals_plain_version(cuda, shape):
    args = _spectra(*shape, n_cols=16, seed=shape[0], device=cuda)
    before = dkernel.doppler_az_responses.launches
    got = doppler_az.set_responses(*args, set_idx=SETS, nv=shape[3])
    torch.cuda.synchronize()
    assert dkernel.doppler_az_responses.launches == before + 1
    want = doppler_az.set_responses_reference(*args, set_idx=SETS, nv=shape[3])
    assert got.shape == (shape[0], 4, shape[4], shape[3])
    assert torch.equal(got, want)


def test_group_responses_equal_plain_and_unpaired_layout(cuda):
    b, w, nv, av = 4, 19, 70, 60
    u_re, u_im, wgt, fct, fst = _spectra(b, 12, w, nv, av, n_cols=16, seed=3,
                                         device=cuda)
    fct[:, 4:8], fct[:, 12:16] = fct[:, 0:4], fct[:, 8:12]
    fst[:, 4:8], fst[:, 12:16] = fst[:, 0:4], fst[:, 8:12]
    idx = torch.tensor(SETS, device=cuda)

    def pair(u):  # [B, 8, W*2nv]: the two sets of a group side by side
        g = u.view(b, 12, w, nv)[:, idx].reshape(b, 2, 2, 4, w, nv)
        return g.permute(0, 1, 3, 4, 2, 5).reshape(b, 8, w * 2 * nv).contiguous()

    cols = [0, 1, 2, 3, 8, 9, 10, 11]
    args = (pair(u_re), pair(u_im), wgt, fct[:, cols].contiguous(),
            fst[:, cols].contiguous())
    got = doppler_az.group_responses(*args, n_groups=2, n_rx=4, nv2=2 * nv)
    want = doppler_az.set_responses_reference(
        *args, set_idx=doppler_az.group_set_idx(2, 4), nv=2 * nv)
    assert torch.equal(got, want)
    unpaired = doppler_az.set_responses(u_re, u_im, wgt, fct, fst, set_idx=SETS,
                                        nv=nv)
    sets = torch.stack([got[:, 0, :, :nv], got[:, 0, :, nv:], got[:, 1, :, :nv],
                        got[:, 1, :, nv:]], dim=1)
    assert torch.equal(sets, unpaired)


@pytest.mark.parametrize("case", ["strided", "cpu", "mixed"])
def test_response_kernel_rejects_what_it_does_not_take(cuda, case):
    u_re, u_im, wgt, fct, fst = _spectra(2, 12, 3, 8, 5, n_cols=16, seed=4,
                                         device=cuda)
    if case == "strided":
        fct = torch.empty(16, 5, device=cuda).T
        match = "contiguous"
    elif case == "cpu":
        u_re, u_im, wgt, fct, fst = (t.cpu() for t in (u_re, u_im, wgt, fct, fst))
        match = "needs CUDA tensors"
    else:
        fct = fct.cpu()
        match = "needs CUDA tensors"
    with pytest.raises(ValueError, match=match):
        dkernel.doppler_az_responses(u_re, u_im, wgt, fct, fst, set_idx=SETS, nv=8)


def test_response_kernel_takes_an_empty_batch(cuda):
    args = _spectra(0, 12, 19, 70, 60, n_cols=16, seed=5, device=cuda)
    before = dkernel.doppler_az_responses.launches
    out = doppler_az.set_responses(*args, set_idx=SETS, nv=70)
    assert out.shape == (0, 4, 60, 70)
    assert dkernel.doppler_az_responses.launches == before


@pytest.mark.parametrize("enable_precise", [False, True], ids=["coarse", "precise"])
def test_velocity_on_cuda_matches_cpu_and_launches_the_kernel(cuda, enable_precise):
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    raw_re, raw_im, alts = make_inputs(cfg, 4, seed=7)
    cpu = build_velocity_pipeline(cfg, enable_precise=enable_precise, device="cpu")
    gumbel = cpu.draw_gumbel(4, torch.Generator().manual_seed(0))
    inputs = [torch.from_numpy(a) for a in (raw_re, raw_im, alts)]
    want = cpu(*inputs, gumbel=gumbel)
    gpu = build_velocity_pipeline(cfg, enable_precise=enable_precise, device=cuda)
    dkernel.doppler_az_responses.launches = 0
    got = gpu(*(t.to(cuda) for t in inputs), gumbel=gumbel.to(cuda))
    torch.cuda.synchronize()
    assert dkernel.doppler_az_responses.launches == (2 if enable_precise else 1)
    torch.testing.assert_close(got.vx.cpu(), want.vx, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.velocity.cpu(), want.velocity, rtol=0, atol=1e-4)
