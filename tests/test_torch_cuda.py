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
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
    build_capon_pipeline,
    build_point_cloud_pipeline,
    build_velocity_pipeline,
    load_cfg,
    make_inputs,
)
from mmwave_radar_processing_tpu_torch.ops import beamform, cfar, doppler_az
from mmwave_radar_processing_tpu_torch.ops.kernels import beamform as bkernel
from mmwave_radar_processing_tpu_torch.ops.kernels import doppler_az as dkernel
from mmwave_radar_processing_tpu_torch.ops.kernels import os_cfar as kernel
from mmwave_radar_processing_tpu_torch.ops.kernels import rank_select
from mmwave_radar_processing_tpu_torch.processors import (
    PointCloudGenerator,
    RangeDetector,
    RangeDopplerDetectorSequential,
)
from mmwave_radar_processing_tpu_torch.processors.virtual_array import reformat

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


# --------------------------------------------------------------------------- #
# the Capon and Bartlett kernels
# --------------------------------------------------------------------------- #
#: kernel against its plain version: the JAX package's kernel-vs-oracle bar
#: (tests/test_beamform.py:380,426); Bartlett's covariance form cancels at
#: deep nulls, hence an atol relative to the map's maximum
BEAMFORM_RTOL = 5e-5
BEAMFORM_SHAPES = [(1, 4, 63, 70, 64), (7, 4, 63, 70, 64), (1024, 4, 63, 70, 64),
                   (2, 12, 63, 70, 64), (3, 7, 1, 70, 2048), (3, 16, 5, 50, 64),
                   (2, 5, 3, 33, 31)]
BEAMFORM_IDS = ["b1", "b7", "b1024", "a12", "az_el", "a16", "odd"]


def _beamform_inputs(b, a, w, k, m, seed, device):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, a, w, k)) + 1j * rng.standard_normal((b, a, w, k)))
    steer = beamform.steering_ula(np.linspace(-np.pi, np.pi, m, endpoint=False), a)
    return torch.from_numpy(x.astype(np.complex64)).to(device), steer.to(device)


def _assert_beamform_close(got, want):
    torch.testing.assert_close(got, want, rtol=BEAMFORM_RTOL,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("shape", BEAMFORM_SHAPES, ids=BEAMFORM_IDS)
def test_capon_kernel_matches_plain_version(cuda, shape):
    x, steer = _beamform_inputs(*shape, seed=shape[0], device=cuda)
    before = bkernel.capon_power.launches
    got = beamform.capon_power(x, steer, loading=1e-2)
    torch.cuda.synchronize()
    assert bkernel.capon_power.launches == before + 1
    want = beamform.capon_power_reference(x, steer, loading=1e-2)
    assert got.shape == (shape[0], shape[2], shape[4])
    torch.testing.assert_close(got, want, rtol=BEAMFORM_RTOL, atol=0)


@pytest.mark.parametrize("shape", BEAMFORM_SHAPES, ids=BEAMFORM_IDS)
def test_bartlett_kernel_matches_both_plain_forms(cuda, shape):
    x, steer = _beamform_inputs(*shape, seed=shape[0] + 1, device=cuda)
    before = bkernel.bartlett_power.launches
    got = beamform.bartlett_power(x, steer)
    torch.cuda.synchronize()
    assert bkernel.bartlett_power.launches == before + 1
    _assert_beamform_close(got, beamform.bartlett_power_reference(x, steer))
    # TPU kernel #9's plain form, mean_k |a^H x_k|^2
    _assert_beamform_close(got, beamform.bartlett_from_snapshots(x.movedim(1, 2), steer))


@pytest.mark.parametrize("case", ["cpu", "strided", "antennas", "mixed"])
@pytest.mark.parametrize("fn", ["capon", "bartlett"])
def test_beamform_kernels_reject_what_they_do_not_take(cuda, case, fn):
    x, steer = _beamform_inputs(2, 4, 3, 8, 5, seed=0, device=cuda)
    match = "need CUDA tensors"
    if case == "cpu":
        x, steer = x.cpu(), steer.cpu()
    elif case == "strided":
        x, match = x.transpose(2, 3), "contiguous"
    elif case == "antennas":
        x, steer = _beamform_inputs(1, 17, 3, 8, 5, seed=0, device=cuda)
        match = "1 to 16"
    else:
        steer = steer.cpu()
    launch = bkernel.capon_power if fn == "capon" else bkernel.bartlett_power
    before = launch.launches
    with pytest.raises(ValueError, match=match):
        launch(x, steer, loading=1e-2) if fn == "capon" else launch(x, steer)
    assert launch.launches == before


def test_beamform_kernels_take_an_empty_batch(cuda):
    x, steer = _beamform_inputs(0, 4, 63, 70, 64, seed=0, device=cuda)
    before = (bkernel.capon_power.launches, bkernel.bartlett_power.launches)
    assert beamform.capon_power(x, steer, loading=1e-2).shape == (0, 63, 64)
    assert beamform.bartlett_power(x, steer).shape == (0, 63, 64)
    assert (bkernel.capon_power.launches, bkernel.bartlett_power.launches) == before


@pytest.mark.parametrize("method", ["capon", "bartlett"])
def test_capon_pipeline_on_cuda_matches_cpu_and_launches_the_kernel(cuda, method):
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    raw_re, raw_im, _ = make_inputs(cfg, 4, seed=7)
    inputs = [torch.from_numpy(a) for a in (raw_re, raw_im)]
    want = build_capon_pipeline(cfg, method=method, device="cpu")(*inputs)
    launch = bkernel.capon_power if method == "capon" else bkernel.bartlett_power
    launch.launches = 0
    got = build_capon_pipeline(cfg, method=method, device=cuda)(
        *(t.to(cuda) for t in inputs))
    torch.cuda.synchronize()
    assert launch.launches == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("cls", [BartlettBeamformerProcessor, CaponBeamformerProcessor],
                         ids=["bartlett", "capon"])
def test_beamformer_processors_on_cuda_match_cpu(cuda, cls):
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    raw_re, raw_im, _ = make_inputs(cfg, 1, seed=7)
    virt = reformat(torch.complex(torch.from_numpy(raw_re), torch.from_numpy(raw_im)),
                    num_rx=cfg.num_rx_antennas, cfgs_per_loop=cfg.chirp_cfgs_per_loop)[0]
    cpu, gpu = cls(cfg, device="cpu"), cls(cfg, device=cuda)
    launch = bkernel.capon_power if cls is CaponBeamformerProcessor \
        else bkernel.bartlett_power
    launch.launches = 0
    heat = gpu.process(virt.to(cuda))
    az_el = gpu.azimuth_elevation_heatmap(virt, 20)
    torch.cuda.synchronize()
    assert launch.launches == 2
    want = cpu.process(virt)
    torch.testing.assert_close(heat.cpu(), want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    want_az_el = cpu.azimuth_elevation_heatmap(virt, 20)
    np.testing.assert_allclose(az_el, want_az_el, rtol=1e-4,
                               atol=1e-4 * np.abs(want_az_el).max())


# --------------------------------------------------------------------------- #
# the rank-selection kernels: the OS-CFAR 2D noise map and the k-th smallest
# --------------------------------------------------------------------------- #
ZERO_GUARD = dict(num_train=(3, 2), num_guard=(0, 0), rho=0.5, alpha=2.0)
ROW_GUARD = dict(num_train=(2, 4), num_guard=(1, 0), rho=0.9, alpha=2.0)
NO_ROW_TRAIN = dict(num_train=(0, 3), num_guard=(2, 1), rho=0.3, alpha=2.0)


@pytest.mark.parametrize("params", [FLAGSHIP, SECOND, ZERO_GUARD, ROW_GUARD, NO_ROW_TRAIN],
                         ids=["flagship", "second", "zero_guard", "row_guard",
                              "no_row_train"])
@pytest.mark.parametrize("shape", [(1, 63, 70), (7, 63, 70), (64, 63, 70), (3, 17, 15),
                                   (5, 64, 128), (2, 256, 192)])
def test_noise_kernel_equals_plain_version(cuda, params, shape):
    """Equal on every cell (a k-th smallest is exact), ties forced; os_2d pads it."""
    x = _quantized_maps(shape, seed=shape[0], device=cuda)
    _, _, mask, k = cfar._geometry(params["num_train"], params["num_guard"], params["rho"])
    if shape[1] < mask.shape[0] or shape[2] < mask.shape[1]:
        pytest.skip("map smaller than this window")
    geometry = dict(num_train=params["num_train"], num_guard=params["num_guard"])
    before = kernel.os_cfar_2d_noise.launches
    thr, noise = cfar.os_2d(x, **params)
    torch.cuda.synchronize()
    assert kernel.os_cfar_2d_noise.launches == before + 1
    want = cfar.os_2d_noise_reference(x, k=k, **geometry)
    er, ed = (mask.shape[0] - 1) // 2, (mask.shape[1] - 1) // 2
    core = noise[:, er : shape[1] - er, ed : shape[2] - ed]
    assert torch.equal(core, want)
    assert torch.equal(thr[:, er : shape[1] - er, ed : shape[2] - ed],
                       params["alpha"] * want)
    edges = torch.ones(shape[1:], dtype=torch.bool, device=cuda)
    edges[er : shape[1] - er, ed : shape[2] - ed] = False
    assert bool(torch.isinf(thr[:, edges]).all()) and bool((noise[:, edges] == 0).all())
    # the identity the two OS-CFAR kernels check each other by
    assert torch.equal(x > thr, cfar.os_2d_detect(x, **params))


def test_noise_kernel_sorts_infinities_last_and_signs_right(cuda):
    x = _quantized_maps((4, 30, 30), seed=3, device=cuda) - 1.0  # negatives and zeros
    x[0, ::3, ::2] = float("inf")
    x[1, ::2, ::3] = float("-inf")
    x[2, ::2] = -0.0
    for rho in (0.05, 0.5, 0.98):
        params = dict(num_train=(3, 3), num_guard=(1, 1), rho=rho, alpha=2.0)
        _, _, _, k = cfar._geometry(params["num_train"], params["num_guard"], rho)
        _, noise = cfar.os_2d(x, **params)
        want = cfar.os_2d_noise_reference(x, num_train=(3, 3), num_guard=(1, 1), k=k)
        assert torch.equal(noise[:, 4:-4, 4:-4], want)


def test_os_2d_answers_a_map_smaller_than_a_window_without_a_launch(cuda):
    x = _quantized_maps((2, 10, 12), seed=5, device=cuda)
    before = kernel.os_cfar_2d_noise.launches
    thr, noise = cfar.os_2d(x, **FLAGSHIP)
    assert kernel.os_cfar_2d_noise.launches == before
    assert bool(torch.isinf(thr).all()) and bool((noise == 0).all())


@pytest.mark.parametrize("case", ["cpu", "dtype", "strided", "rank", "k_low", "k_high",
                                  "small"])
def test_noise_kernel_rejects_what_it_does_not_take(cuda, case):
    x = _quantized_maps((2, 40, 40), seed=0, device=cuda)
    kw = dict(num_train=(5, 5), num_guard=(3, 2), k=154)
    if case == "cpu":
        x = x.cpu()
    elif case == "dtype":
        x = x.double()
    elif case == "strided":
        x = x[:, :, ::2]
    elif case == "rank":
        x = x[0]
    elif case == "k_low":
        kw["k"] = 0
    elif case == "k_high":
        kw["k"] = 221
    elif case == "small":
        x = x[:, :16, :14].contiguous()
    with pytest.raises((ValueError, TypeError)):
        kernel.os_cfar_2d_noise(x, **kw)


@pytest.mark.parametrize("shape,ks", [((500, 152), (1, 77, 106, 152)), ((1, 1), (1,)),
                                      ((3, 10), (1, 5, 10)), ((4097, 24), (12,)),
                                      ((100, 32), (7, 32)), ((100, 33), (7, 33)),
                                      ((300, 220), (154,)), ((3, 257), (1, 200, 257)),
                                      ((100003, 10), (6,))])
def test_kth_smallest_kernel_equals_plain_version(cuda, shape, ks):
    x = _quantized_maps(shape, seed=shape[1], device=cuda) - 0.5
    if shape[0] > 2:
        x[0, ::2] = float("inf")
        x[1] = x[1, 0]  # a row of one value
    for k in ks:
        before = rank_select.kth_smallest.launches
        got = cfar._rank_reduce(x, k)
        torch.cuda.synchronize()
        assert rank_select.kth_smallest.launches == before + 1
        assert torch.equal(got, cfar.kth_smallest_reference(x, k))


@pytest.mark.parametrize("case", ["cpu", "dtype", "strided", "rank", "k_low", "k_high"])
def test_kth_smallest_kernel_rejects_what_it_does_not_take(cuda, case):
    x = _quantized_maps((8, 24), seed=0, device=cuda)
    k = 12
    if case == "cpu":
        x = x.cpu()
    elif case == "dtype":
        x = x.double()
    elif case == "strided":
        x = x[:, ::2]
    elif case == "rank":
        x = x[0]
    elif case == "k_low":
        k = 0
    elif case == "k_high":
        k = 25
    with pytest.raises((ValueError, TypeError)):
        rank_select.kth_smallest(x, k)


def test_rank_kernels_take_an_empty_batch(cuda):
    assert rank_select.kth_smallest(torch.empty((0, 24), device=cuda), 3).shape == (0,)
    out = kernel.os_cfar_2d_noise(torch.empty((0, 63, 70), device=cuda),
                                  num_train=(5, 5), num_guard=(3, 2), k=154)
    assert out.shape == (0, 47, 56)


def test_os_1d_on_cuda_equals_cpu(cuda):
    x = _quantized_maps((5, 63, 70), seed=9, device=cuda)
    kw = dict(num_train=12, num_guard=4, rho=0.5, alpha=15.0)
    before = rank_select.kth_smallest.launches
    thr, noise = cfar.os_1d(x, **kw)
    assert rank_select.kth_smallest.launches == before + 1
    thr_cpu, noise_cpu = cfar.os_1d(x.cpu(), **kw)
    assert torch.equal(thr.cpu(), thr_cpu) and torch.equal(noise.cpu(), noise_cpu)


def test_detector_api_on_cuda_matches_cpu_and_launches_the_kernels(cuda):
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    raw_re, raw_im, _ = make_inputs(cfg, 2, seed=7)
    virt = reformat(torch.complex(torch.from_numpy(raw_re), torch.from_numpy(raw_im)),
                    num_rx=4, cfgs_per_loop=3)
    pcg_kw = dict(az_antenna_idxs=[0, 3, 4, 7], el_antenna_idxs=[9, 8, 5, 4],
                  detector_type="range_doppler_detector_2d",
                  detector_params=dict(cfar_type="os_cfar_2d", cfar_params=FLAGSHIP))
    for aoa in ("fft", "capon"):
        gpu = PointCloudGenerator(cfg, aoa_method=aoa, device=cuda, **pcg_kw)
        cpu = PointCloudGenerator(cfg, aoa_method=aoa, device="cpu", **pcg_kw)
        kernel.os_cfar_2d_noise.launches = 0
        for frame in virt:
            got, want = gpu.process(frame.to(cuda)), cpu.process(frame)
            assert got.shape == want.shape and len(want) > 0
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert kernel.os_cfar_2d_noise.launches == len(virt)
    for cls in (RangeDetector, RangeDopplerDetectorSequential):
        rank_select.kth_smallest.launches = 0
        gpu, cpu = cls(cfg, device=cuda), cls(cfg, device="cpu")
        for frame in virt:
            assert np.array_equal(gpu.process(frame.to(cuda)), cpu.process(frame))
        assert rank_select.kth_smallest.launches >= len(virt)
