"""The port's Capon/Bartlett pipeline against the JAX package's, on the CPU.

Both run ``utils/verify.make_inputs`` frames.  On the CPU the JAX pipeline
resolves ``capon_method="auto"`` to ``"linv"`` (the unrolled Cholesky of the
real 2A x 2A embedding) and ``bartlett_backend=None`` to ``"xla"``; the tests
also run its TPU kernels there in interpret mode (``capon_method="pallas"``,
``bartlett_backend="pallas_cov"``).  The port runs its plain versions.  The
bar is that of ``tests/test_beamform.py:319-320`` (batch pipeline against
the processor): rtol 1e-4, atol 1e-4 times the map's maximum, which covers
Bartlett's cancellation at deep nulls.
"""

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu.config import grids
from mmwave_radar_processing_tpu.data import PointTarget, Scene, simulate_frames
from mmwave_radar_processing_tpu.ops import beamform as jbf, mxu, windows
from mmwave_radar_processing_tpu.parallel.capon_pipeline import (
    build_capon_pipeline as build_jax_capon,
)
from mmwave_radar_processing_tpu.processors.virtual_array import reformat as jax_reformat
from mmwave_radar_processing_tpu.utils.verify import make_inputs
from mmwave_radar_processing_tpu_torch import (
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
    CaponPipeline,
    build_capon_pipeline,
    load_capon_constants,
)

torch.set_num_threads(2)  # tier-1 runs several xdist workers

AZ_IDXS = (0, 3, 4, 7)
RTOL = 1e-4
METHODS = ["capon", "bartlett"]


def _assert_maps_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def frames(flagship_config):
    raw_re, raw_im, _ = make_inputs(flagship_config, 3, seed=7)
    return raw_re, raw_im


def _virtual(cfg, raw_re, raw_im):
    """Reformatted virtual cubes ``[B, 12, ns, loops]`` of the raw planes."""
    def one(plane):
        return np.array(jax_reformat(plane, num_rx=cfg.num_rx_antennas,
                                     cfgs_per_loop=cfg.chirp_cfgs_per_loop))
    return one(raw_re), one(raw_im)


@pytest.mark.parametrize("reformat_input", [True, False], ids=["raw", "virtual"])
@pytest.mark.parametrize("method", METHODS)
def test_pipeline_matches_jax(flagship_config, frames, method, reformat_input):
    re, im = frames if reformat_input else _virtual(flagship_config, *frames)
    kw = dict(antenna_idxs=AZ_IDXS, method=method, loading=1e-2,
              reformat_input=reformat_input)
    want = np.asarray(build_jax_capon(flagship_config, **kw)(re, im))
    got = build_capon_pipeline(flagship_config, device="cpu", **kw)(
        torch.from_numpy(re), torch.from_numpy(im))
    assert got.shape == (3, flagship_config.num_adc_samples, 64)
    _assert_maps_close(got.numpy(), want)


@pytest.mark.parametrize("method,backend", [
    ("capon", dict(capon_method="pallas")),
    ("bartlett", dict(bartlett_backend="pallas_cov")),
], ids=METHODS)
def test_pipeline_matches_jax_interpret_kernels(flagship_config, frames, method,
                                                backend):
    re, im = frames[0][:1], frames[1][:1]
    want = np.asarray(build_jax_capon(flagship_config, antenna_idxs=AZ_IDXS,
                                      method=method, **backend)(re, im))
    got = build_capon_pipeline(flagship_config, antenna_idxs=AZ_IDXS, method=method,
                               device="cpu")(torch.from_numpy(re), torch.from_numpy(im))
    _assert_maps_close(got.numpy(), want)


@pytest.mark.parametrize("n_ant,m", [((0, 3, 4, 7), 64), (tuple(range(12)), 32),
                                     ((1, 5, 9), 48)], ids=["ods_az", "virtual12", "odd"])
@pytest.mark.parametrize("method", METHODS)
def test_pipeline_options_match_jax(flagship_config, frames, method, n_ant, m):
    re, im = frames[0][:2], frames[1][:2]
    kw = dict(antenna_idxs=n_ant, num_angle_bins=m, method=method, loading=3e-2)
    want = np.asarray(build_jax_capon(flagship_config, **kw)(re, im))
    got = build_capon_pipeline(flagship_config, device="cpu", **kw)(
        torch.from_numpy(re), torch.from_numpy(im))
    assert got.shape == (2, flagship_config.num_adc_samples, m)
    _assert_maps_close(got.numpy(), want)


@pytest.mark.parametrize("method,cls", [("capon", CaponBeamformerProcessor),
                                        ("bartlett", BartlettBeamformerProcessor)],
                         ids=METHODS)
def test_pipeline_matches_processor(flagship_config, method, cls):
    scenes = [Scene(targets=[PointTarget(range_m=1.0 + 0.2 * i, azimuth_rad=0.1 * i,
                                         velocity_m_s=0.2 * (i % 2), rcs=3.0)])
              for i in range(3)]
    raw = simulate_frames(flagship_config, scenes).astype(np.complex64)
    re = np.real(raw).astype(np.float32)
    im = np.imag(raw).astype(np.float32)
    batch = build_capon_pipeline(flagship_config, antenna_idxs=AZ_IDXS, method=method,
                                 loading=1e-2, device="cpu")(
        torch.from_numpy(re), torch.from_numpy(im)).numpy()
    virt_re, virt_im = _virtual(flagship_config, re, im)
    p = cls(flagship_config, antenna_idxs=AZ_IDXS, diagonal_loading=1e-2, device="cpu")
    for i in range(3):
        single = p.process(virt_re[i] + 1j * virt_im[i]).numpy()
        np.testing.assert_allclose(batch[i], single, rtol=RTOL,
                                   atol=1e-4 * single.max())


@pytest.mark.parametrize("method", METHODS)
def test_pipeline_peaks_on_planted_target(flagship_config, method):
    scene = Scene(targets=[PointTarget(range_m=1.5, azimuth_rad=-0.3,
                                       velocity_m_s=0.4, rcs=4.0)], noise_sigma=0.05)
    raw = simulate_frames(flagship_config, [scene, scene])
    heat = build_capon_pipeline(flagship_config, method=method, device="cpu")(
        torch.from_numpy(np.real(raw).astype(np.float32)),
        torch.from_numpy(np.imag(raw).astype(np.float32)))[0].numpy()
    r_i, a_i = np.unravel_index(np.argmax(heat), heat.shape)
    range_bins = grids.range_bins(flagship_config, variant="eps")
    assert abs(range_bins[r_i] - 1.5) < 2 * flagship_config.range_res_m
    assert abs(grids.angle_bins(64)[a_i] + 0.3) < 2 * np.pi / 63


def _jax_constants(cfg, n_ant, m):
    ns = cfg.num_adc_samples
    rng_cos, rng_sin = mxu.dft_factors(ns, window=windows.hanning(ns))
    steer = jbf.steering_ula(grids.phase_shift_bins(m), n_ant)
    return {"rng_cos": np.asarray(rng_cos), "rng_sin": np.asarray(rng_sin),
            "steer_re": np.asarray(steer.re), "steer_im": np.asarray(steer.im)}


def test_own_constants_equal_jax_constants(flagship_config):
    pipeline = build_capon_pipeline(flagship_config, device="cpu")
    consts = _jax_constants(flagship_config, 4, 64)
    np.testing.assert_array_equal(pipeline.rng_dft.real.numpy(), consts["rng_cos"])
    np.testing.assert_array_equal(pipeline.rng_dft.imag.numpy(), -consts["rng_sin"])
    np.testing.assert_array_equal(pipeline.steering.real.numpy(), consts["steer_re"])
    np.testing.assert_array_equal(pipeline.steering.imag.numpy(), consts["steer_im"])


@pytest.mark.parametrize("method", METHODS)
def test_loaded_constants_reproduce_jax(flagship_config, frames, method):
    pipeline = build_capon_pipeline(flagship_config, method=method, device="cpu")
    with torch.no_grad():
        pipeline.rng_dft.zero_()
        pipeline.steering.zero_()
    load_capon_constants(pipeline, _jax_constants(flagship_config, 4, 64))
    want = np.asarray(build_jax_capon(flagship_config, method=method)(*frames))
    got = pipeline(*(torch.from_numpy(a) for a in frames)).numpy()
    _assert_maps_close(got, want)


@pytest.mark.parametrize("change", ["missing", "unknown", "shape"])
def test_load_capon_constants_checks_names_and_shapes(flagship_config, change):
    pipeline = build_capon_pipeline(flagship_config, device="cpu")
    consts = _jax_constants(flagship_config, 4, 64)
    if change == "missing":
        del consts["steer_im"]
    elif change == "unknown":
        consts["angle_bins"] = np.zeros(64, np.float32)
    else:
        consts["steer_re"] = consts["steer_re"][:, :32]
    with pytest.raises(ValueError):
        load_capon_constants(pipeline, consts)


@pytest.mark.parametrize("option", [
    dict(capon_method="linv"), dict(capon_method="solve"),
    dict(capon_method="pallas"), dict(bartlett_backend="pallas"),
    dict(bartlett_backend="xla"), dict(bartlett_backend="pallas_cov"),
    dict(method="music"),
], ids=lambda o: "=".join(map(str, *o.items())))
def test_tpu_selectors_raise(flagship_config, option):
    with pytest.raises(ValueError):
        build_capon_pipeline(flagship_config, device="cpu", **option)


def test_pipeline_is_a_module_with_buffers(flagship_config):
    pipeline = build_capon_pipeline(flagship_config, device="cpu")
    assert isinstance(pipeline, CaponPipeline)
    assert {"rng_dft", "steering", "chans"} <= set(dict(pipeline.named_buffers()))
    assert pipeline.steering.shape == (4, 64)
    with pytest.raises(TypeError):
        build_capon_pipeline(flagship_config)  # no implicit default device


@pytest.mark.parametrize("case", ["shape", "dtype", "chirps"])
def test_pipeline_checks_its_inputs(flagship_config, case):
    pipeline = build_capon_pipeline(flagship_config, device="cpu")
    shape = (1, 4, flagship_config.num_adc_samples, flagship_config.chirps_per_frame)
    re = torch.zeros(shape)
    error = ValueError
    if case == "shape":
        re = re[0]
    elif case == "dtype":
        re, error = re.double(), TypeError
    else:
        re = re[..., :70]
    with pytest.raises(error):
        pipeline(re, re)
