"""Tests of the port that need a CUDA device: the hand-written kernels have no CPU mode.

They carry the ``cuda`` marker and skip where ``torch.cuda.is_available()``
is False.  This file imports no JAX, so it also runs on a GPU machine without
JAX, where ``tests/conftest.py`` (which imports JAX) cannot load:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import (
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
    build_capon_pipeline,
    build_ground_point_cloud_pipeline,
    build_point_cloud_pipeline,
    build_velocity_pipeline,
    load_cfg,
    make_inputs,
)
from mmwave_radar_processing_tpu_torch.ops import (
    altitude, beamform, cfar, doppler_az, masked, peaks,
)
from mmwave_radar_processing_tpu_torch.ops.kernels import altitude_track as akernel
from mmwave_radar_processing_tpu_torch.ops.kernels import beamform as bkernel
from mmwave_radar_processing_tpu_torch.ops.kernels import doppler_az as dkernel
from mmwave_radar_processing_tpu_torch.ops.kernels import os_cfar as kernel
from mmwave_radar_processing_tpu_torch.ops.kernels import peaks as pkernel
from mmwave_radar_processing_tpu_torch.ops.kernels import rank_select
from mmwave_radar_processing_tpu_torch.ops.kernels import steering as skernel
from mmwave_radar_processing_tpu_torch.processors import (
    PointCloudGenerator,
    RangeDetector,
    RangeDopplerDetectorSequential,
)
from mmwave_radar_processing_tpu_torch.parallel.velocity_pipeline import MIN_PROMINENCE_DB, _db
from mmwave_radar_processing_tpu_torch.processors import synthetic_array as sa
from mmwave_radar_processing_tpu_torch.processors.virtual_array import reformat

import peak_rows
from steering_inputs import LAMBDA_M, STEERING_ATOL, cruise_positions, steering_grid

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
    # a map smaller than one window has no interior cell: answered without a launch
    assert kernel.os_cfar_2d_detect.launches == before + (shape != (2, 10, 12))
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


@pytest.mark.parametrize("av,sets", [
    (7, SETS), (13, ((0, 3, 4), (1, 2, 5), (10, 11, 6))), (60, ((0, 3, 4), (9, 8, 5))),
    (11, ((0, 1, 2, 3, 4), (5, 6, 7, 8, 9))), (64, SETS), (1, SETS), (25, ((3,), (7,))),
    (62, SETS),
], ids=["av7", "av13_rx3", "av60_rx3", "av11_rx5", "av64", "av1", "av25_rx1", "av62"])
@pytest.mark.parametrize("batch", [1, 33])
def test_response_kernel_masks_ragged_angle_blocks_and_takes_any_antenna_count(
        cuda, av, sets, batch):
    """Angle counts with 1, 2 and 3 bins in the last block of 4; antennas a set other than 4."""
    n_cols = len(sets) * len(sets[0])
    args = _spectra(batch, 12, 19, 70, av, n_cols=n_cols, seed=av, device=cuda)
    before = dkernel.doppler_az_responses.launches
    got = doppler_az.set_responses(*args, set_idx=sets, nv=70)
    torch.cuda.synchronize()
    assert dkernel.doppler_az_responses.launches == before + 1
    assert got.shape == (batch, len(sets), av, 70)
    assert torch.equal(got, doppler_az.set_responses_reference(*args, set_idx=sets, nv=70))


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
    dkernel.doppler_az_responses.launches = pkernel.prominent_peak.launches = 0
    got = gpu(*(t.to(cuda) for t in inputs), gumbel=gumbel.to(cuda))
    torch.cuda.synchronize()
    assert dkernel.doppler_az_responses.launches == (2 if enable_precise else 1)
    assert pkernel.prominent_peak.launches == 1  # the zoom pass picks its peaks once
    torch.testing.assert_close(got.vx.cpu(), want.vx, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.velocity.cpu(), want.velocity, rtol=0, atol=1e-4)


# --------------------------------------------------------------------------- #
# the velocity peak picker
# --------------------------------------------------------------------------- #
def _assert_peaks_equal(x, min_prominence):
    before = pkernel.prominent_peak.launches
    idx, found = peaks.best_prominent_peak(x, min_prominence)
    torch.cuda.synchronize()
    assert pkernel.prominent_peak.launches == before + (x.numel() > 0)
    want_idx, want_found = peaks.best_prominent_peak_reference(x, min_prominence)
    assert idx.shape == found.shape == x.shape[:-1]
    assert idx.dtype == torch.int64 and found.dtype == torch.bool
    assert torch.equal(idx, want_idx), int((idx != want_idx).sum())
    assert torch.equal(found, want_found), int((found != want_found).sum())
    return found


@pytest.mark.parametrize("planes", ["noise", "scenes"])
def test_peak_kernel_equals_plain_version_on_the_pipelines_maps(cuda, planes):
    """The velocity path's own dB maps [B, 2, 70, 60]: 1024 frames of noise, 4 simulated scenes."""
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    pipe = build_velocity_pipeline(cfg, stop_after="responses", device=cuda)
    if planes == "noise":
        gen = torch.Generator(device=cuda).manual_seed(0)
        raw = [torch.randn((1024, 4, 63, 210), generator=gen, device=cuda) for _ in "ri"]
        alts = torch.full((1024,), 1.2, device=cuda)
    else:
        *raw, alts = (torch.from_numpy(a).to(cuda) for a in make_inputs(cfg, 4, seed=7))
    db = _db(torch.stack(pipe(*raw, alts), dim=1), pipe.peak_threshold_db)
    assert db.shape == (raw[0].shape[0], 2, 70, 60) and db.is_contiguous()
    found = _assert_peaks_equal(db, MIN_PROMINENCE_DB)
    assert bool(found.any()) and not bool(found.all())
    for min_prominence in (0.0, 2.0, 12.0):
        _assert_peaks_equal(db, min_prominence)


@pytest.mark.parametrize("n", peak_rows.WIDTHS)
def test_peak_kernel_equals_plain_version(cuda, n):
    """Quantised rows (ties, prominences on the floors), dB rows, and the special rows."""
    rows = max(64, min(4096, 2 ** 26 // (n * n)))  # the plain version's [rows, N/2, N] masks
    x = np.concatenate([peak_rows.quantised_rows(rows, n, seed=n),
                        peak_rows.db_rows(rows, n, seed=n + 1),
                        peak_rows.special_rows(n, seed=n + 2)])
    x = torch.from_numpy(x).to(cuda)
    for min_prominence in peak_rows.THRESHOLDS + (4.000000001,):
        _assert_peaks_equal(x, min_prominence)
    _assert_peaks_equal(x[:7].reshape(7, 1, n), 1.0)  # a last block of 7 rows


def test_peak_kernel_takes_rows_off_a_16_byte_boundary_and_empty_batches(cuda):
    x = torch.from_numpy(peak_rows.quantised_rows(999, 60, seed=3)).to(cuda)
    storage = torch.empty(x.numel() + 1, device=cuda)
    view = storage[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    _assert_peaks_equal(view, 1.0)
    for shape in [(0, 60), (3, 0, 60)]:
        idx, found = peaks.best_prominent_peak(torch.empty(shape, device=cuda), 4.0)
        assert idx.shape == found.shape == shape[:-1]


@pytest.mark.parametrize("case", ["strided", "float64", "too_wide"])
def test_peak_kernel_rejects_what_it_does_not_take(cuda, case):
    x = torch.from_numpy(peak_rows.quantised_rows(8, 60, seed=4)).to(cuda)
    if case == "strided":
        x, err = x[:, ::2], ValueError
    elif case == "float64":
        x, err = x.double(), TypeError
    else:
        x, err = torch.zeros((2, pkernel.MAX_N + 1), device=cuda), ValueError
    before = pkernel.prominent_peak.launches
    with pytest.raises(err):
        peaks.best_prominent_peak(x, 4.0)
    with pytest.raises(err):
        pkernel.prominent_peak(x, 4.0)
    assert pkernel.prominent_peak.launches == before


# --------------------------------------------------------------------------- #
# the Capon and Bartlett kernels
# --------------------------------------------------------------------------- #
#: kernel against its plain version: the JAX package's kernel-vs-oracle bar
#: (tests/test_beamform.py:380,426); Bartlett's covariance form cancels at
#: deep nulls, hence an atol relative to the map's maximum
BEAMFORM_RTOL = 5e-5
#: then the shapes that reach the kernel's tile geometry: tiles that straddle
#: frames (B*W not a multiple of the 16-row tile), W = 1 with N not a multiple
#: of the tile, odd K (8-byte copies), a config-sized cube, A = 1, A = 12 at
#: the 2048-angle grid, and rows longer than a stage (chunks of K, even and odd)
BEAMFORM_SHAPES = [(1, 4, 63, 70, 64), (7, 4, 63, 70, 64), (1024, 4, 63, 70, 64),
                   (2, 12, 63, 70, 64), (3, 7, 1, 70, 2048), (3, 16, 5, 50, 64),
                   (2, 5, 3, 33, 31), (67, 4, 63, 70, 64), (4300, 4, 1, 70, 64),
                   (70, 4, 63, 33, 64), (17, 4, 256, 192, 64), (300, 1, 16, 70, 64),
                   (3, 12, 1, 70, 2048), (2, 16, 3, 500, 64), (3, 16, 2, 401, 5)]
BEAMFORM_IDS = ["b1", "b7", "b1024", "a12", "az_el", "a16", "odd", "straddle", "w1",
                "odd_k", "config_cube", "a1", "a12_m2048", "chunked", "chunked_odd"]


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


def test_beamform_kernels_take_a_view_off_16_bytes(cuda):
    # x one element into its storage: the runs are not 16-byte aligned, so the
    # kernels copy 8-byte elements in place of bulk copies
    shape = (67, 4, 63, 70, 64)
    x, steer = _beamform_inputs(*shape, seed=5, device=cuda)
    storage = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    view = storage[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    torch.testing.assert_close(beamform.capon_power(view, steer, loading=1e-2),
                               beamform.capon_power_reference(x, steer, loading=1e-2),
                               rtol=BEAMFORM_RTOL, atol=0)
    _assert_beamform_close(beamform.bartlett_power(view, steer),
                           beamform.bartlett_power_reference(x, steer))


def test_beamform_kernel_geometry_equals_the_model(cuda):
    # the library's host code against ops/kernels/beamform.py's model, which
    # the CPU tests check (tests/test_torch_beamform_tiles.py)
    for rows, n_ant, w, k, m in [(64512, 4, 63, 70, 64), (64512, 4, 1, 70, 64),
                                 (63, 12, 63, 70, 64), (1, 12, 1, 70, 2048),
                                 (4221, 4, 63, 70, 64), (4900, 2, 7, 10, 8),
                                 (4352, 4, 256, 192, 64), (6, 16, 3, 500, 64),
                                 (4410, 4, 63, 33, 31), (1, 1, 1, 1, 1)]:
        for aligned in (True, False):
            assert bkernel.kernel_launch_geometry(rows, n_ant, k, m, aligned) == \
                bkernel.launch_geometry(rows, n_ant, k, m, aligned)
        geo = bkernel.launch_geometry(rows, n_ant, k, m)
        for tile in sorted({0, 1, geo.tiles // 2, geo.tiles - 1} & set(range(geo.tiles))):
            for chunk in range(geo.n_chunks):
                assert bkernel.kernel_tile_runs(rows, n_ant, w, k, m, tile, chunk) == \
                    bkernel.tile_runs(rows, n_ant, w, k, m, tile, chunk)


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
NARROW = dict(num_train=(2, 1), num_guard=(1, 0), rho=0.6, alpha=2.0)  # a 3-column window
ONE_COLUMN = dict(num_train=(3, 0), num_guard=(1, 0), rho=0.5, alpha=2.0)
EVEN_TRAIN = dict(num_train=(3, 4), num_guard=(1, 3), rho=0.8, alpha=2.0)


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


@pytest.mark.parametrize("params", [FLAGSHIP, SECOND, NARROW, ONE_COLUMN, EVEN_TRAIN],
                         ids=["flagship", "second", "narrow", "one_column", "even_train"])
@pytest.mark.parametrize("shape", [(1024, 63, 70), (1, 18, 16), (3, 17, 20), (1, 66, 77),
                                   (9, 50, 45), (2, 100, 90), (200, 31, 33)])
def test_noise_kernel_equals_plain_version_on_tiled_maps(cuda, params, shape):
    """Cores that no tile divides, one tile plus a cell, every batch's own tiling."""
    x = _quantized_maps(shape, seed=shape[1], device=cuda)
    x[:, ::4, ::5] = float("inf")
    _, _, mask, k = cfar._geometry(params["num_train"], params["num_guard"], params["rho"])
    geometry = dict(num_train=params["num_train"], num_guard=params["num_guard"])
    geo = kernel.noise_launch_geometry(shape[1], shape[2], batch=shape[0], **geometry)
    before = kernel.os_cfar_2d_noise.launches
    got = kernel.os_cfar_2d_noise(x, k=k, **geometry)
    torch.cuda.synchronize()
    assert kernel.os_cfar_2d_noise.launches == before + 1
    want = cfar.os_2d_noise_reference(x, k=k, **geometry)
    assert torch.equal(got, want), (geo, int((got != want).sum()))


@pytest.mark.parametrize("num_train,num_guard", [((2, 13), (1, 2)), ((2, 14), (1, 2)),
                                                 ((1, 15), (0, 0)), ((1, 16), (1, 16)),
                                                 ((0, 31), (1, 1)), ((2, 32), (1, 0))],
                         ids=["w31", "w33_t14", "w31_no_guard", "w65_t16", "w65_t31",
                              "w65_t32"])
@pytest.mark.parametrize("batch", [1, 40])
def test_noise_kernel_unrolls_runs_up_to_31_columns_and_loops_beyond(cuda, num_train,
                                                                     num_guard, batch):
    """Either side of the widest run whose length the kernel has as a constant."""
    x = _quantized_maps((batch, 40, 90), seed=batch, device=cuda)
    x[:, ::5, ::3] = float("inf")
    for rho in (0.1, 0.75):
        k = cfar._geometry(num_train, num_guard, rho)[3]
        got = kernel.os_cfar_2d_noise(x, num_train=num_train, num_guard=num_guard, k=k)
        want = cfar.os_2d_noise_reference(x, num_train=num_train, num_guard=num_guard, k=k)
        assert torch.equal(got, want)


def test_noise_kernel_takes_the_largest_window_it_sorts(cuda):
    """An 85 x 65 window: a region above the preferred size, flushed half-precision counts."""
    x = _quantized_maps((2, 90, 70), seed=1, device=cuda)
    geometry = dict(num_train=(40, 30), num_guard=(2, 2))
    geo = kernel.noise_launch_geometry(90, 70, batch=2, **geometry)
    assert geo.sort_size > kernel.PREFERRED_REGION or geo.tile_r * geo.tile_d <= 64
    for k in (1, 2750, 5500):
        got = kernel.os_cfar_2d_noise(x, k=k, **geometry)
        assert torch.equal(got, cfar.os_2d_noise_reference(x, k=k, **geometry))
    # a 101 x 85 window: a region of 8,888 values, the 16,384-key sort's own instance
    x = _quantized_maps((3, 104, 90), seed=2, device=cuda)
    geometry = dict(num_train=(48, 40), num_guard=(2, 2))
    assert kernel.noise_launch_geometry(104, 90, batch=3, **geometry).sort_size == 16384
    for k in (1, 6000, 8560):
        got = kernel.os_cfar_2d_noise(x, k=k, **geometry)
        assert torch.equal(got, cfar.os_2d_noise_reference(x, k=k, **geometry))


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


@pytest.mark.parametrize("field,value", [
    ("tile_d", 54), ("tiles_r", 2), ("tiles_d", 2), ("words_per_row", 36),
    ("words_per_row", 33), ("sort_size", 4096), ("sort_size", 12288), ("sort_size", 32768),
    ("passes", 12), ("passes", 15), ("row_split", 3), ("row_split", 64),
])
def test_noise_entry_point_refuses_an_inconsistent_geometry(cuda, field, value):
    """A geometry that does not fit the map would give wrong values with no CUDA error."""
    x = _quantized_maps((1024, 63, 70), seed=0, device=cuda)
    out = torch.empty((1024, 47, 56), device=cuda)
    whole = kernel.noise_launch_geometry(63, 70, (5, 5), (3, 2), 1024)  # one tile a frame
    assert (whole.tile_d, whole.words_per_row, whole.sort_size, whole.passes) == (56, 37, 8192, 13)
    geo = whole._replace(**{field: value})
    launch = kernel._noise_kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    err = launch(x.data_ptr(), out.data_ptr(), 1024, 63, 70, 5, 5, 3, 2, 154, geo.tile_r,
                 geo.tile_d, geo.tiles_r, geo.tiles_d, geo.words_per_row, geo.sort_size,
                 geo.passes, geo.row_split, stream)
    assert err == 1  # cudaErrorInvalidValue, and nothing launched
    torch.cuda.synchronize()


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


# --------------------------------------------------------------------------- #
# the redesigned detection kernel (tiles, strips, run lengths) and its compacting entry
# --------------------------------------------------------------------------- #
DETECT_WINDOWS = {
    "flagship": FLAGSHIP, "second": SECOND, "zero_guard": ZERO_GUARD, "narrow": NARROW,
    "one_column": ONE_COLUMN,
    "no_side_columns": dict(num_train=(2, 0), num_guard=(1, 2), rho=0.5, alpha=1.5),
    "no_rows_above": dict(num_train=(0, 3), num_guard=(2, 1), rho=0.5, alpha=1.5),
    "runs_of_31": dict(num_train=(1, 12), num_guard=(1, 3), rho=0.5, alpha=2.0),
    "runs_of_33": dict(num_train=(1, 13), num_guard=(1, 3), rho=0.5, alpha=2.0),
    "side_runs_of_32": dict(num_train=(1, 32), num_guard=(0, 1), rho=0.5, alpha=2.0),
}


@pytest.mark.parametrize("name", list(DETECT_WINDOWS))
@pytest.mark.parametrize("shape", [(1, 63, 70), (7, 63, 70), (200, 63, 70), (1, 66, 77),
                                   (3, 40, 81), (2, 256, 192)],
                         ids=lambda s: "x".join(map(str, s)))
def test_detection_kernel_equals_plain_version_at_any_window_and_tiling(cuda, name, shape):
    params = DETECT_WINDOWS[name]
    x = _quantized_maps(shape, seed=shape[1], device=cuda)
    x[:, ::9, ::7] = float("inf")
    want = cfar.os_2d_detect_reference(x, **params)
    got = cfar.os_2d_detect(x, **params)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(want.any())
    # the two OS-CFAR kernels check each other
    assert torch.equal(x > cfar.os_2d(x, **params)[0], got)


@pytest.mark.parametrize("name", ["flagship", "second", "narrow", "runs_of_33", "no_side_columns"])
@pytest.mark.parametrize("shape", [(1, 63, 70), (65, 63, 70), (9, 128, 128), (3, 17, 15),
                                   (3, 256, 192)], ids=lambda s: "x".join(map(str, s)))
def test_compacting_entry_equals_mask_to_indices_2d(cuda, name, shape):
    """Frames with no detection, exactly ``capacity`` and more; a frame too large for a block."""
    params = DETECT_WINDOWS[name]
    x = _quantized_maps(shape, seed=shape[2], device=cuda)
    if shape[0] > 1:
        x[0] = 1.0  # no detection
    mask = cfar.os_2d_detect_reference(x, **params)
    counts = mask.sum(dim=(1, 2))
    (tr, td), (gr, gd) = params["num_train"], params["num_guard"]
    interior = shape[1] > 2 * (tr + gr) and shape[2] > 2 * (td + gd)
    fits = kernel.frame_fits_one_block(shape[1], shape[2], (tr, td), (gr, gd))
    assert fits == (interior and shape[1] < 256)
    for capacity in sorted({1, 128, max(1, int(counts.median())), int(counts.max()) + 2}):
        before = kernel.os_cfar_2d_detect.launches
        got = cfar.os_2d_detect_compact(x, capacity, **params)
        torch.cuda.synchronize()
        assert kernel.os_cfar_2d_detect.launches == before + interior
        want = masked.mask_to_indices_2d(mask, capacity)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_compacting_entry_keeps_leading_dimensions_and_empty_batches(cuda):
    x = _quantized_maps((2, 3, 63, 70), seed=4, device=cuda)
    got = cfar.os_2d_detect_compact(x, 16, **FLAGSHIP)
    want = masked.mask_to_indices_2d(cfar.os_2d_detect_reference(x, **FLAGSHIP), 16)
    assert got[0].shape == (2, 3, 16) and got[3].shape == (2, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    empty = kernel.os_cfar_2d_detect_compact(torch.empty((0, 63, 70), device=cuda), 8,
                                             num_train=(5, 5), num_guard=(3, 2), k=154, alpha=4.0)
    assert empty[0].shape == (0, 8) and empty[3].shape == (0,)
    small = cfar.os_2d_detect_compact(x[..., :10, :12], 8, **FLAGSHIP)  # no interior cell
    assert not bool(small[2].any()) and not bool(small[3].any())


@pytest.mark.parametrize("field,value", [
    ("tile_d", 54), ("tile_d", 52), ("tiles_r", 2), ("tiles_d", 2), ("stride", 72),
    ("stride", 90), ("row_split", 3), ("row_split", 64), ("tile_r", 40),
])
def test_detect_entry_point_refuses_an_inconsistent_geometry(cuda, field, value):
    """A geometry that does not fit the map would give a wrong mask with no CUDA error."""
    x = _quantized_maps((8, 63, 70), seed=0, device=cuda)
    out = torch.empty((8, 63, 70), dtype=torch.bool, device=cuda)
    whole = kernel.detect_launch_geometry(63, 70, (5, 5), (3, 2), 1024)
    assert (whole.tile_r, whole.tile_d, whole.stride) == (47, 56, 88)
    geo = whole._replace(**{field: value})
    stream = torch.cuda.current_stream(cuda).cuda_stream
    err = kernel._kernel()(x.data_ptr(), out.data_ptr(), 8, 63, 70, 5, 5, 3, 2, 154, 4.0,
                           geo.tile_r, geo.tile_d, geo.tiles_r, geo.tiles_d, geo.stride,
                           geo.row_split, stream)
    assert err == 1  # cudaErrorInvalidValue, and nothing launched
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["cpu", "dtype", "strided", "rank", "k_low", "small",
                                  "capacity", "too_large_for_a_block"])
def test_detection_entries_reject_what_they_do_not_take(cuda, case):
    x = _quantized_maps((2, 63, 70), seed=0, device=cuda)
    kw = dict(num_train=(5, 5), num_guard=(3, 2), k=154, alpha=4.0)
    capacity = 16
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
    elif case == "small":
        x = x[:, :10, :12].contiguous()
    elif case == "capacity":
        capacity = 0
    else:
        x = _quantized_maps((1, 256, 192), seed=0, device=cuda)
    with pytest.raises((ValueError, TypeError)):
        kernel.os_cfar_2d_detect_compact(x, capacity, **kw)
    if case not in ("capacity", "too_large_for_a_block"):
        with pytest.raises((ValueError, TypeError)):
            kernel.os_cfar_2d_detect(x, **kw)


# --------------------------------------------------------------------------- #
# the k-th-smallest kernel: a kernel for each range of widths
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 7, 8, 9, 12, 15, 16, 17, 20, 23, 24, 25, 28, 31,
                               32, 33, 40, 64, 65, 100, 128, 129, 220, 256, 257, 300])
@pytest.mark.parametrize("m", [1, 259, 4097])
def test_kth_smallest_equals_plain_version_at_every_width(cuda, w, m):
    """Every width's instance, rows not a multiple of the block; ties, ``+inf``, both zeros."""
    x = _quantized_maps((m, w), seed=w, device=cuda) - 0.5
    x[0, ::2] = float("inf")
    if m > 2:
        x[1] = x[1, 0].clone()
        x[2, ::3], x[2, 1::3] = -0.0, 0.0
    for k in sorted({1, max(1, (7 * w) // 10), w}):
        want = cfar.kth_smallest_reference(x, k)
        got = rank_select.kth_smallest(x, k)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        # one of the inputs, bit for bit: a zero keeps its sign bit's row
        assert bool((got.view(torch.int32)[:, None] == x.view(torch.int32)).any(1).all())


def test_kth_smallest_takes_rows_off_a_16_byte_boundary(cuda):
    """A view one float into its storage: no width's kernel assumes an alignment."""
    for w in (24, 220, 300):
        base = _quantized_maps((1, w * 300 + 1), seed=3, device=cuda)[0]
        x = base[1:].view(300, w)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        assert torch.equal(rank_select.kth_smallest(x, w // 2),
                           cfar.kth_smallest_reference(x, w // 2))


# --------------------------------------------------------------------------- #
# the altitude-recursion kernel of the ground scan
# --------------------------------------------------------------------------- #
def _track_inputs(t, seed, device):
    """Candidates on a 1/8 m grid (ties), runs of equal candidates, frames with none eligible."""
    rng = np.random.default_rng(seed)
    cand = np.round(rng.uniform(0.0, 2.0, (t, 3)) * 8).astype(np.float32) / 8
    cand[::11] = cand[::11, :1]  # three equal candidates
    cand[5::13] = 3.0  # nothing within the gate
    valid = rng.random((t, 3)) < 0.7
    valid[7::17] = False  # no valid candidate
    zbins = (cand[..., None] + np.round(rng.uniform(-0.3, 0.3, (t, 3, 2)) * 16) / 16
             ).astype(np.float32)
    zvalid = rng.random((t, 3, 2)) < 0.8
    return [torch.from_numpy(a).to(device) for a in (cand, valid, zbins, zvalid)]


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("t", [1, 7, 1024, 5000])
def test_altitude_kernel_equals_plain_version(cuda, t, precise):
    cand, valid, zbins, zvalid = _track_inputs(t, seed=t, device=cuda)
    init = torch.tensor(0.9, device=cuda)
    kw = dict(min_altitude_m=0.25, altitude_search_limit_m=0.4, range_bias=0.05,
              precise=precise)
    before = akernel.altitude_track.launches
    got = altitude.altitude_track(cand, valid, zbins, zvalid, init, **kw)
    torch.cuda.synchronize()
    assert akernel.altitude_track.launches == before + 1
    want = altitude.altitude_track_reference(cand, valid, zbins, zvalid, init, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if t > 7:
        assert len(torch.unique(want[0])) > 10  # the track moves


def test_ground_pipeline_on_cuda_matches_cpu_and_launches_the_kernel_once(cuda):
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")
    raw_re, raw_im, _ = make_inputs(cfg, 8, seed=7)
    akernel.altitude_track.launches = 0
    got = build_ground_point_cloud_pipeline(cfg, altitude_search_limit_m=1.5, device=cuda)(
        torch.from_numpy(raw_re).to(cuda), torch.from_numpy(raw_im).to(cuda))
    torch.cuda.synchronize()
    assert akernel.altitude_track.launches == 1
    want = build_ground_point_cloud_pipeline(cfg, altitude_search_limit_m=1.5, device="cpu")(
        torch.from_numpy(raw_re), torch.from_numpy(raw_im))
    assert (got.altitude.cpu() - want.altitude).abs().max() <= 5e-3
    assert int(want.count.sum()) > 0
    assert torch.equal(got.count.cpu(), want.count)


# --------------------------------------------------------------------------- #
# the synthetic-aperture steering phases
# --------------------------------------------------------------------------- #
RADSAR_CFG = os.path.join(os.path.dirname(__file__), "..", "configs",
                          "RadSAR_1843_official.cfg")
STEERING_CASES = {
    # the RadSAR cell's widths: A = 960 directions, E = 800 elements
    "cell": lambda: (steering_grid(), cruise_positions(3)),
    "positions_2d": lambda: (steering_grid(), cruise_positions(1)[0]),
    "odd_e": lambda: (steering_grid(7, 3), cruise_positions(2, chirps=99, num_frames=3)),
    "calibration_a3": lambda: (steering_grid(3, 1), cruise_positions(1, num_frames=4)[0]),
    # E = 4100 and 4101: three tiles of elements, the last 4 and 5 long
    "element_tiles": lambda: (steering_grid(5, 2), cruise_positions(2, num_frames=41)),
    "odd_element_tiles": lambda: (steering_grid(33, 1),
                                  cruise_positions(1, num_frames=3, chirps=1367)),
    "leading_axes": lambda: (steering_grid(4, 4),
                             cruise_positions(6, num_frames=2).reshape(2, 3, 3, -1)),
    # a strided view: the dispatch makes it contiguous for the kernel
    "positions_view": lambda: (steering_grid(6, 2), cruise_positions(2, chirps=200)[..., ::2]),
}


@pytest.mark.parametrize("case", list(STEERING_CASES))
def test_steering_kernel_equals_plain_version(cuda, case):
    steering, positions = (t.to(cuda) for t in STEERING_CASES[case]())
    before = skernel.steering_phases.launches
    got = sa.steering_phases(steering, positions, LAMBDA_M)
    torch.cuda.synchronize()
    assert skernel.steering_phases.launches == before + 1
    want = sa.steering_phases_reference(steering, positions, LAMBDA_M)
    assert got.shape == want.shape == (*positions.shape[:-2], steering.shape[0],
                                       positions.shape[-1])
    assert got.dtype == torch.complex64 and got.is_contiguous()
    assert float((got - want).abs().max()) <= STEERING_ATOL
    if case == "cell":
        max_angle = float((steering @ positions).abs().max()) * 2 * np.pi / LAMBDA_M
        assert max_angle > 400  # the range the bar is set for


def test_steering_kernel_counts_one_launch_a_call_and_none_for_an_empty_batch(cuda):
    steering, positions = steering_grid(6, 2).to(cuda), cruise_positions(2).to(cuda)
    before = skernel.steering_phases.launches
    for k in range(1, 4):
        sa.steering_phases(steering, positions, LAMBDA_M)
        assert skernel.steering_phases.launches == before + k
    for shape in [(0, 3, 800), (2, 3, 0)]:
        out = sa.steering_phases(steering, torch.empty(shape, device=cuda), LAMBDA_M)
        assert out.shape == (shape[0], 12, shape[2]) and out.dtype == torch.complex64
    out = sa.steering_phases(steering[:0], positions, LAMBDA_M)
    assert out.shape == (2, 0, 800)
    torch.cuda.synchronize()
    assert skernel.steering_phases.launches == before + 3


@pytest.mark.parametrize("case", ["float64", "strided_steering", "steering_shape",
                                  "positions_shape", "mixed_devices"])
def test_steering_kernel_rejects_what_it_does_not_take(cuda, case):
    steering, positions = steering_grid(4, 2).to(cuda), cruise_positions(2).to(cuda)
    err = ValueError
    if case == "float64":
        positions, err = positions.double(), TypeError
    elif case == "strided_steering":
        steering = torch.zeros((8, 6), device=cuda)[:, ::2]
    elif case == "steering_shape":
        steering = torch.zeros((8, 4), device=cuda)
    elif case == "positions_shape":
        positions = torch.zeros((2, 800, 3), device=cuda)
    else:
        steering = steering.cpu()
    before = skernel.steering_phases.launches
    with pytest.raises(err):
        skernel.steering_phases(steering, positions, LAMBDA_M)
    assert skernel.steering_phases.launches == before


def test_synthetic_aperture_pipeline_on_cuda_meets_the_plain_reference(cuda):
    """One call of the deployment's pipeline against the benchmark's plain reference.

    ``port_bench/reference/sar.py`` builds each frame's aperture anew; the
    pipeline's depth map is held to the cell's own limits.
    """
    from port_bench.gen import flight as gen_flight
    from port_bench.reference import sar as ref_sar
    from port_bench.reference.radar import parse_cfg
    from port_bench.traffic.sar import build_pipeline, sar_numbers

    root = os.path.join(os.path.dirname(__file__), "..", "port_bench")
    with open(os.path.join(root, "configs", "iwr1843-radsar-10hz.json")) as fh:
        p = json.load(fh)["processing"]
    with open(os.path.join(root, "workloads", "radsar1843-flight-bulk.json")) as fh:
        limits = json.load(fh)["limits"]
    with open(RADSAR_CFG) as fh:
        radar = parse_cfg(fh.read().splitlines())
    n = 64
    f = gen_flight.flight(radar, 0.1, n, 2 ** 31 + 22, cuda)
    pipe = build_pipeline(load_cfg(RADSAR_CFG, array_geometry="standard"), p, cuda)
    skernel.steering_phases.launches = 0
    with torch.no_grad():
        got = pipe(f.re, f.im, f.vels)
    torch.cuda.synchronize()
    assert skernel.steering_phases.launches == 1
    ref = ref_sar.depth_maps(f.re, f.im, f.vels, np.arange(n), radar, p, 0.1)
    numbers = sar_numbers(*(t.cpu().numpy() for t in got), ref)
    assert int(ref.ok.sum()) > n // 2  # the cruise passes the gate after the first F-1 frames
    for name, limit in limits.items():
        assert numbers[name] <= limit, (name, numbers)
