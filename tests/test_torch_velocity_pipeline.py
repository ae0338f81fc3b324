"""The port's velocity and combined pipelines against the JAX package's, on the CPU.

Both run ``utils/verify.make_inputs`` frames and altitudes.  On the CPU the
JAX velocity pipeline resolves ``response_backend="auto"`` to its XLA einsum
chain; the port runs its plain response version.  RANSAC gets the JAX
pipeline's own Gumbel draws, recomputed here (``split(PRNGKey(seed), B)``,
then ``split`` into the azimuth and elevation keys of each frame, then one
key per trial), because the JAX PRNG cannot be reproduced in PyTorch.  The
bars are those of ``tests/test_mxu.py:538-550``: ``vx`` within 1e-5 (1e-4
with the zoom pass), ``velocity`` within 1e-4, R^2 and inlier fractions
within 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmwave_radar_processing_tpu.config import grids
from mmwave_radar_processing_tpu.data import ground_scene, simulate_frame
from mmwave_radar_processing_tpu.ops import mxu
from mmwave_radar_processing_tpu.parallel.full_pipeline import (
    build_full_pipeline as build_jax_full,
)
from mmwave_radar_processing_tpu.parallel.velocity_pipeline import (
    build_velocity_pipeline as build_jax_velocity,
)
from mmwave_radar_processing_tpu.utils.verify import make_inputs
from mmwave_radar_processing_tpu_torch import (
    build_full_pipeline,
    build_velocity_pipeline,
    load_velocity_constants,
)

torch.set_num_threads(2)  # tier-1 runs several xdist workers

SEED = 42
FIELDS = ("velocity", "vx", "az_r2", "el_r2", "az_inlier", "el_inlier")


def jax_draws(seed, batch, n, max_trials=20):
    """The JAX pipeline's RANSAC scores ``[B, 2, T, n]``, azimuth fit first."""
    out = np.empty((batch, 2, max_trials, n), np.float32)
    for b, key in enumerate(jax.random.split(jax.random.PRNGKey(seed), batch)):
        for f, fit_key in enumerate(jax.random.split(key)):
            for t, trial_key in enumerate(jax.random.split(fit_key, max_trials)):
                out[b, f, t] = np.asarray(jax.random.gumbel(trial_key, (n,)))
    return out


@pytest.fixture(scope="module")
def frames(flagship_config):
    return make_inputs(flagship_config, 8, seed=7)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _run_velocity(cfg, frames, **kw):
    want = build_jax_velocity(cfg, **kw)(*frames)
    port = build_velocity_pipeline(cfg, device="cpu", **kw)
    gumbel = torch.from_numpy(jax_draws(SEED, frames[0].shape[0], port.ransac_rows))
    return port(*_torch(*frames), gumbel=gumbel), want


def _assert_velocity_close(got, want, vx_tol):
    np.testing.assert_allclose(got.vx.numpy(), np.asarray(want.vx), rtol=0,
                               atol=vx_tol)
    np.testing.assert_allclose(got.velocity.numpy(), np.asarray(want.velocity),
                               rtol=0, atol=1e-4)
    for name in FIELDS[2:]:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def coarse(flagship_config, frames):
    return _run_velocity(flagship_config, frames)


@pytest.fixture(scope="module")
def precise(flagship_config, frames):
    return _run_velocity(flagship_config, frames, enable_precise=True)


def test_velocity_matches_jax(coarse):
    got, want = coarse
    assert got.velocity.shape == (8, 3) and got.velocity.dtype == torch.float32
    for name in FIELDS[1:]:
        assert getattr(got, name).shape == (8,)
    _assert_velocity_close(got, want, vx_tol=1e-5)
    # not vacuous: vx readouts and RANSAC fits happen on these frames
    assert (got.vx != 0).sum() >= 6 and (got.az_r2 != 0).any()


def test_precise_velocity_matches_jax(precise):
    got, want = precise
    _assert_velocity_close(got, want, vx_tol=1e-4)
    assert (got.az_r2 != 0).all() and (got.el_r2 != 0).all()


def _jax_window(cfg, altitude, lower=0.5, upper=0.5):
    """``start`` and ``rmask`` as the JAX pipeline computes them (``velocity_pipeline.py:294-318``)."""
    ns = cfg.num_adc_samples
    win_rows = min(ns, int(np.ceil((lower + upper) / cfg.range_res_m)) + 2)
    range_bins = jnp.asarray(grids.range_bins(cfg, variant="eps"))

    def one(alt):
        lo = jnp.maximum(0.0, alt - lower)
        hi = jnp.minimum(cfg.range_max_m, alt + upper)
        start = jnp.clip(jnp.sum(range_bins < lo).astype(jnp.int32), 0, ns - win_rows)
        bins_w = (start.astype(jnp.float32)
                  + jnp.arange(win_rows, dtype=jnp.float32)) * cfg.range_res_m
        return start, ((bins_w >= lo) & (bins_w <= hi)).astype(jnp.float32)

    return [np.asarray(a) for a in jax.jit(jax.vmap(one))(altitude)]


def test_altitude_window_equals_jax(flagship_config, frames):
    rng = np.random.default_rng(3)
    # the frames' altitudes, the range edges, and altitudes on bin edges
    alts = np.concatenate([
        frames[2], [0.0, 0.2, 0.5, 3.5, 3.9, 10.0],
        0.5 + np.arange(0, 40) * flagship_config.range_res_m,
        rng.uniform(0, 4, 64)]).astype(np.float32)
    start, rmask = build_velocity_pipeline(flagship_config, device="cpu") \
        .altitude_window(torch.from_numpy(alts))
    w_start, w_rmask = _jax_window(flagship_config, alts)
    np.testing.assert_array_equal(start.numpy(), w_start)
    np.testing.assert_array_equal(rmask.numpy(), w_rmask)
    assert rmask.shape == (alts.size, 19)


def test_responses_match_jax(flagship_config, frames):
    want = build_jax_velocity(flagship_config, stop_after="responses")(*frames)
    got = build_velocity_pipeline(flagship_config, stop_after="responses",
                                  device="cpu")(*_torch(*frames))
    for g, w in zip(got, want):
        assert g.shape == (8, 70, 60)
        # the JAX chain sums the angle DFT and the range window in another
        # order: rtol 1e-5, atol 1e-5 of the largest response
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_stop_after_stages_are_prefixes(flagship_config, frames, coarse):
    got, _ = coarse
    vx = build_velocity_pipeline(flagship_config, stop_after="vx",
                                 device="cpu")(*_torch(*frames))
    assert torch.equal(vx, got.vx)
    az_a, az_v, az_f, el_a, el_f, p_vx = build_velocity_pipeline(
        flagship_config, stop_after="peaks", device="cpu")(*_torch(*frames))
    assert az_a.shape == az_v.shape == az_f.shape == el_a.shape == (8, 70)
    assert az_f.dtype == torch.bool and torch.equal(p_vx, got.vx)
    w_peaks = build_jax_velocity(flagship_config, stop_after="peaks")(*frames)
    np.testing.assert_array_equal(az_f.numpy(), np.asarray(w_peaks[2]))
    np.testing.assert_array_equal(el_f.numpy(), np.asarray(w_peaks[4]))
    np.testing.assert_array_equal(az_a.numpy(), np.asarray(w_peaks[0]))


def test_combined_matches_jax(flagship_config, frames):
    """The JAX default ``aoa_precision="fast"``: on the CPU its one-hot
    contractions run in float32, so the port's ``"f32"`` is held to it."""
    want_pc, want_vel = build_jax_full(flagship_config)(*frames)
    full = build_full_pipeline(flagship_config, device="cpu")
    gumbel = torch.from_numpy(jax_draws(SEED, 8, 70))
    pc, vel = full(*_torch(*frames), gumbel=gumbel)
    np.testing.assert_array_equal(pc.count.numpy(), np.asarray(want_pc.count))
    np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(want_pc.valid))
    np.testing.assert_allclose(pc.points.numpy(), np.asarray(want_pc.points),
                               rtol=0, atol=1e-5)
    _assert_velocity_close(vel, want_vel, vx_tol=1e-5)
    assert int(pc.count.sum()) > 0


def _jax_constants(cfg):
    loops = cfg.frame.loops
    cc, cs = mxu.dft_factors(loops, window=np.hanning(loops), shift=True)
    azc, azs = mxu.aoa_factors(4, 64, shift=True)
    elc, els = mxu.aoa_factors(4, 64, shift=False)
    consts = dict(chirp_cos=cc, chirp_sin=cs, az_cos=azc, az_sin=azs, el_cos=elc,
                  el_sin=els, range_bins=grids.range_bins(cfg, variant="eps"),
                  vel_bins=grids.vel_bins(cfg), angle_bins=grids.angle_bins(64))
    return {k: np.asarray(v, np.float32) for k, v in consts.items()}


def test_constants_carry_over_from_jax(flagship_config, frames, coarse):
    pipeline = build_velocity_pipeline(flagship_config, device="cpu")
    before = {n: b.clone() for n, b in pipeline.named_buffers()}
    loaded = ("chirp_dft", "fct", "fst", "range_bins", "vel_bins", "valid_angle_bins")
    with torch.no_grad():
        for name in loaded:
            getattr(pipeline, name).zero_()
    load_velocity_constants(pipeline, _jax_constants(flagship_config))
    # the port's own constants are the JAX package's, bit for bit
    for name, buf in pipeline.named_buffers():
        assert torch.equal(buf, before[name]), name
    got = pipeline(*_torch(*frames), gumbel=torch.from_numpy(jax_draws(SEED, 8, 70)))
    for g, w in zip(got, coarse[0]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fault", ["missing", "unknown", "shape", "angles"])
def test_load_velocity_constants_rejects_mismatches(flagship_config, fault):
    consts = _jax_constants(flagship_config)
    if fault == "missing":
        del consts["chirp_sin"]
    elif fault == "unknown":
        consts["extra"] = np.zeros(1)
    elif fault == "shape":
        consts["az_cos"] = consts["az_cos"][:, :32]
    else:
        consts["angle_bins"] = consts["angle_bins"][:60]
    with pytest.raises(ValueError):
        load_velocity_constants(build_velocity_pipeline(flagship_config,
                                                        device="cpu"), consts)


@pytest.fixture(scope="module")
def ground_frames(flagship_config):
    rng = np.random.default_rng(4)
    ego = np.array([0.5, 0.12, -0.05])
    raw = np.stack([
        simulate_frame(flagship_config,
                       ground_scene(flagship_config, altitude_m=1.2, ego_vel=ego,
                                    num_patches=64, rng=rng, noise_sigma=0.03), rng)
        for _ in range(3)])
    return (np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32),
            np.full(3, 1.2, np.float32)), ego


@pytest.mark.parametrize("enable_precise", [False, True], ids=["coarse", "precise"])
def test_own_generator_is_seeded_and_reads_vx_near_truth(flagship_config,
                                                         ground_frames,
                                                         enable_precise):
    (re, im, alts), ego = ground_frames
    inputs = _torch(re, im, alts)
    pipeline = build_velocity_pipeline(flagship_config, enable_precise=enable_precise,
                                       min_r2_threshold=0.2, min_inlier_percent=0.3,
                                       device="cpu")
    a, b = pipeline(*inputs), pipeline(*inputs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (torch.abs(a.vx - float(ego[0])) < 0.12).all()  # tests/test_mxu.py:261
    assert torch.isfinite(a.velocity).all()
    if enable_precise:  # the coarse rows hold too few peaks for a fit, as in JAX
        assert (a.az_r2 > 0).all() and (a.velocity[:, 0] > 0).all()
    other = build_velocity_pipeline(flagship_config, enable_precise=enable_precise,
                                    min_r2_threshold=0.2, min_inlier_percent=0.3,
                                    seed=7, device="cpu")(*inputs)
    assert torch.equal(other.vx, a.vx)  # vx does not depend on the draws


@pytest.mark.parametrize("option", [dict(response_backend="pallas2"),
                                    dict(response_backend="pallas"),
                                    dict(response_backend="xla"),
                                    dict(stop_after="front")],
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_velocity_options_left_out_of_the_port_raise(flagship_config, option):
    with pytest.raises(ValueError):
        build_velocity_pipeline(flagship_config, device="cpu", **option)


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_full_pipeline_runs_f32_only(flagship_config, precision):
    with pytest.raises(ValueError, match="aoa_precision"):
        build_full_pipeline(flagship_config, aoa_precision=precision, device="cpu")


@pytest.mark.parametrize("case", ["altitude_shape", "altitude_dtype", "gumbel_shape",
                                  "planes"])
def test_velocity_forward_rejects_bad_input(flagship_config, frames, case):
    pipeline = build_velocity_pipeline(flagship_config, device="cpu")
    re, im, alts = _torch(*(a[:2] for a in frames))
    kw, err = {}, ValueError
    if case == "altitude_shape":
        alts = alts[:1]
    elif case == "altitude_dtype":
        alts, err = alts.double(), TypeError
    elif case == "gumbel_shape":
        kw["gumbel"] = torch.zeros(2, 2, 20, 140)
    else:
        re = re[..., :200]
    with pytest.raises(err):
        pipeline(re, im, alts, **kw)


def test_pipeline_state_is_buffers(flagship_config):
    pipeline = build_full_pipeline(flagship_config, device="cpu")
    assert not list(pipeline.parameters())
    names = {n for n, _ in pipeline.velocity.named_buffers()}
    assert {"chirp_dft", "fct", "fst", "range_bins", "vel_bins",
            "valid_angle_bins"} <= names
    assert pipeline.velocity.fct.shape == (60, 16)
    assert pipeline.velocity.win_rows == 19
