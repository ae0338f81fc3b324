"""Parity of the port's velocity-path ops with the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function (Pallas
kernels in interpret mode) and its port.  Peak indices, ``found`` flags and
RANSAC inlier sets must be identical; float results agree to a tolerance
stated with its reason.  RANSAC gets the JAX package's own Gumbel draws,
recomputed here, because its PRNG cannot be reproduced in PyTorch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmwave_radar_processing_tpu.ops import mxu
from mmwave_radar_processing_tpu.ops import peaks as jpeaks
from mmwave_radar_processing_tpu.ops import ransac as jransac
from mmwave_radar_processing_tpu.ops.pallas import doppler_az as jdoppler_az
from mmwave_radar_processing_tpu.processors import velocity_estimator as jvelocity
from mmwave_radar_processing_tpu_torch.ops import dft, doppler_az, peaks, ransac
from mmwave_radar_processing_tpu_torch.ops.kernels import _build
from mmwave_radar_processing_tpu_torch.ops.kernels import doppler_az as kernel
from mmwave_radar_processing_tpu_torch.ops.kernels import peaks as peak_kernel
from mmwave_radar_processing_tpu_torch.processors import velocity_estimator

import peak_rows

torch.set_num_threads(2)  # tier-1 runs several xdist workers

SETS = ((0, 3, 4, 7), (1, 2, 5, 6), (10, 11, 6, 7), (9, 8, 5, 4))


# --------------------------------------------------------------------------- #
# peaks
# --------------------------------------------------------------------------- #
def _rows(kind, seed, n_rows=64, n=60):
    """dB-like rows; ``ties`` rounds to 1/2 dB and plants plateaus and equal peaks."""
    rng = np.random.default_rng(seed)
    x = 20 * np.log10(rng.exponential(1.0, (n_rows, n)) + 1e-3)
    if kind == "ties":
        x = np.round(x * 2) / 2
        x[:, 10:13] = x[:, 11:12] + 3.0  # plateau: no strict maximum
        x[:, 20] = x[:, 30] = x.max(axis=1) + 5.0  # equal highest peaks
        x[:, 19] = x[:, 21] = x[:, 29] = x[:, 31] = x[:, 20] - 10.0
        x[::7] = 1.5  # flat rows: no peak at all
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_local_maxima_equals_jax(kind):
    x = _rows(kind, seed=1)
    want = np.asarray(jax.vmap(jpeaks.local_maxima)(x))
    got = peaks.local_maxima(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "ties":
        assert not got[:, 10:13].any() and got[1, 20] and got[1, 30]


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_candidate_peaks_equal_jax_top_k_order(kind):
    x = _rows(kind, seed=2)
    w_vals, w_idx = jax.vmap(jpeaks._candidate_peaks)(x)
    vals, idx = peaks._candidate_peaks(torch.from_numpy(x))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(w_vals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("min_prominence", [0.0, 4.0, 12.0])
def test_best_prominent_peak_equals_jax(kind, min_prominence):
    x = _rows(kind, seed=3)
    w_idx, w_found = jax.vmap(
        lambda r: jpeaks.best_prominent_peak(r, min_prominence))(x)
    idx, found = peaks.best_prominent_peak(torch.from_numpy(x), min_prominence)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(w_found))
    ref_idx, ref_found = peaks.best_prominent_peak_reference(torch.from_numpy(x), min_prominence)
    np.testing.assert_array_equal(ref_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(ref_found.numpy(), np.asarray(w_found))
    assert found.any()
    if kind == "ties":  # equal highest peaks: the lower index wins
        assert (idx.numpy()[found.numpy()] != 30).all()


def test_peaks_batch_over_leading_dims():
    x = _rows("random", seed=4).reshape(4, 16, 60)
    idx, found = peaks.best_prominent_peak(torch.from_numpy(x), 4.0)
    flat_idx, flat_found = peaks.best_prominent_peak(
        torch.from_numpy(x.reshape(64, 60)), 4.0)
    assert idx.shape == (4, 16)
    assert torch.equal(idx.reshape(64), flat_idx)
    assert torch.equal(found.reshape(64), flat_found)


@pytest.mark.parametrize("n", [w for w in peak_rows.WIDTHS if w <= 140])
def test_the_peak_kernels_algorithm_equals_the_plain_version(n):
    """The walk of ``csrc/prominent_peak.cu``, modelled in numpy, against the pairwise masks.

    Quantised rows (ties in value, prominences exactly at the floors),
    dB-like rows, and plateaus, monotone rows, signed zeros, NaN and
    infinities; the widest row (1,024) is held on the card only, where the
    plain version is fast enough.
    """
    x = np.concatenate([peak_rows.quantised_rows(32, n, seed=n),
                        peak_rows.db_rows(16, n, seed=n + 1),
                        peak_rows.special_rows(n, seed=n + 2)])
    # 4.000000001 rounds to 4.0 in float32: the floor is compared in float32
    for min_prominence in peak_rows.THRESHOLDS + (4.000000001,):
        want_idx, want_found = peaks.best_prominent_peak_reference(torch.from_numpy(x),
                                                                   min_prominence)
        idx, found = peak_rows.model_best_prominent_peak(x, min_prominence)
        np.testing.assert_array_equal(idx, want_idx.numpy())
        np.testing.assert_array_equal(found, want_found.numpy())
        if n >= 31:
            assert want_found.any() and not want_found.all()


def test_peak_picker_takes_the_plain_version_on_cpu():
    peak_kernel.prominent_peak.launches = 0
    x = torch.from_numpy(_rows("ties", seed=5))
    idx, found = peaks.best_prominent_peak(x, 4.0)
    want_idx, want_found = peaks.best_prominent_peak_reference(x, 4.0)
    assert torch.equal(idx, want_idx) and torch.equal(found, want_found)
    assert idx.dtype == torch.int64 and found.dtype == torch.bool
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        peak_kernel.prominent_peak(x, 4.0)
    assert peak_kernel.prominent_peak.launches == 0


@pytest.mark.parametrize("case", ["cpu", "float64", "strided", "empty_row", "too_wide",
                                  "scalar", "meta"])
def test_peak_picker_rejects_what_the_kernel_does_not_take(case):
    """The launch raises on what the kernel does not take, the dispatch on a device without one."""
    x = torch.from_numpy(_rows("random", seed=6))
    err, match = ValueError, None
    if case == "cpu":
        match = "needs a CUDA tensor"
    elif case == "float64":
        x, err, match = x.double(), TypeError, "float32"
    elif case == "strided":
        x, match = x[:, ::2], "contiguous"
    elif case == "empty_row":
        x, match = x[:, :0], "1 to 1024 samples"
    elif case == "too_wide":
        x, match = torch.zeros(2, peak_kernel.MAX_N + 1), "1 to 1024 samples"
    elif case == "scalar":
        x, match = x[0, 0], "1 to 1024 samples"
    else:
        with pytest.raises(ValueError, match="no peak kernel for device"):
            peaks.best_prominent_peak(x.to("meta"), 4.0)
        return
    before = peak_kernel.prominent_peak.launches
    with pytest.raises(err, match=match):
        peak_kernel.prominent_peak(x, 4.0)
    assert peak_kernel.prominent_peak.launches == before


# --------------------------------------------------------------------------- #
# RANSAC
# --------------------------------------------------------------------------- #
def _jax_draws(keys, max_trials, n):
    """The Gumbel scores ``ransac_linear`` draws: ``split(key, T)``, then ``gumbel(k, (n,))``."""
    return np.stack([
        np.stack([np.asarray(jax.random.gumbel(k, (n,)))
                  for k in jax.random.split(key, max_trials)])
        for key in keys]).astype(np.float32)


def _fit_problems(case, n_fits=6, n=70, seed=0):
    """``(h [F, n, D], y [F, n], valid [F, n])`` for one case."""
    rng = np.random.default_rng(seed)
    d = 2 if case == "two_features" else 1
    h = rng.uniform(-1.0, 1.0, (n_fits, n, d)).astype(np.float32)
    coef = rng.normal(0.0, 1.0, (n_fits, d)).astype(np.float32)
    y = np.einsum("fnd,fd->fn", h, coef) + rng.normal(0, 0.05, (n_fits, n))
    outliers = rng.random((n_fits, n)) < 0.3
    y = np.where(outliers, rng.uniform(-3, 3, (n_fits, n)), y).astype(np.float32)
    valid = rng.random((n_fits, n)) < 0.8
    if case == "few_valid":  # n_valid < min_samples: ok False, zero outputs
        valid[:] = False
        valid[:, :7] = True
        valid[0, :] = False
    elif case == "short_rows":  # n < min_samples: k_sample = n, every row sampled
        h, y, valid = h[:, :8], y[:, :8], np.ones((n_fits, 8), bool)
    return h, y, valid


@pytest.mark.parametrize("case", ["random", "few_valid", "short_rows", "two_features"])
def test_ransac_equals_jax_with_injected_draws(case):
    h, y, valid = _fit_problems(case)
    keys = jax.random.split(jax.random.PRNGKey(3), h.shape[0])
    want = jax.vmap(lambda hh, yy, vv, kk: jransac.ransac_linear(
        hh, yy, vv, kk, min_samples=10, residual_threshold=0.15,
        max_trials=20))(h, y, valid, keys)
    scores = torch.from_numpy(_jax_draws(keys, 20, h.shape[1]))
    got = ransac.ransac_linear(torch.from_numpy(h), torch.from_numpy(y),
                               torch.from_numpy(valid), min_samples=10,
                               residual_threshold=0.15, max_trials=20,
                               scores=scores)
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    # float32 sums of up to 70 products in another order
    for name in ("coef", "r2", "inlier_fraction"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    if case == "random":
        assert got.ok.all() and (got.r2 > 0.5).all()
    elif case in ("few_valid", "short_rows"):
        assert not got.ok.any() and not got.coef.any()


def test_ransac_winner_tie_goes_to_the_first_trial_in_float32(monkeypatch):
    """Equal inlier counts: ``n*1e6 + r2 + t*1e-9`` rounds r2 away from 17 inliers on.

    Line A (even trials) has noise, so its R^2 is below line B's exact fit
    (odd trials).  A lexicographic (count, R^2) winner would be a B trial;
    the reference's float32 order makes all trials equal, and the first
    maximum, trial 0 on line A, wins.  The port must do the same.  The JAX
    fit gets the same crafted scores: its key split and Gumbel draw are
    replaced, for this call only, by a lookup of row ``t``.
    """
    rng = np.random.default_rng(5)
    n_half = 40
    x = np.concatenate([np.linspace(0.5, 2.0, n_half)] * 2)
    y = np.concatenate([x[:n_half] + rng.normal(0, 0.02, n_half), -x[n_half:]])
    h = x[:, None].astype(np.float32)
    y = y.astype(np.float32)
    valid = np.ones(2 * n_half, bool)
    scores = np.full((20, 2 * n_half), -1.0, np.float32)
    for t in range(20):
        half = slice(0, n_half) if t % 2 == 0 else slice(n_half, None)
        scores[t, half] = rng.uniform(0.0, 1.0, n_half)

    table = jnp.asarray(scores)
    monkeypatch.setattr(jax.random, "split", lambda key, num: jnp.arange(num))
    monkeypatch.setattr(jax.random, "gumbel", lambda t, shape: table[t])
    with jax.disable_jit():
        want = jransac.ransac_linear(h, y, valid, None, min_samples=10,
                                     residual_threshold=0.15, max_trials=20)
    monkeypatch.undo()
    got = ransac.ransac_linear(torch.from_numpy(h), torch.from_numpy(y),
                               torch.from_numpy(valid), min_samples=10,
                               residual_threshold=0.15, max_trials=20,
                               scores=torch.from_numpy(scores))
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    assert got.inlier_mask[:n_half].all() and not got.inlier_mask[n_half:].any()
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef),
                               rtol=1e-5, atol=1e-6)


def test_ransac_draws_from_a_seeded_generator():
    h, y, valid = (torch.from_numpy(a) for a in _fit_problems("random"))

    def fit(seed):
        gen = torch.Generator().manual_seed(seed)
        return ransac.ransac_linear(h, y, valid, generator=gen)

    a, b = fit(1), fit(1)
    for x, z in zip(a, b):
        assert torch.equal(x, z)
    assert a.ok.all() and (a.r2 > 0.5).all()
    with pytest.raises(ValueError, match="generator"):
        ransac.ransac_linear(h, y, valid)
    with pytest.raises(ValueError, match="scores of shape"):
        ransac.ransac_linear(h, y, valid, scores=torch.zeros(6, 19, 70))


def test_ransac_per_fit_thresholds_broadcast():
    h, y, valid = (torch.from_numpy(a) for a in _fit_problems("random"))
    scores = ransac.gumbel((6, 20, 70), torch.Generator().manual_seed(2))
    thr = torch.tensor([0.15, 0.2, 0.15, 0.2, 0.15, 0.2])
    got = ransac.ransac_linear(h, y, valid, residual_threshold=thr, scores=scores)
    for f in range(6):
        one = ransac.ransac_linear(h[f], y[f], valid[f],
                                   residual_threshold=float(thr[f]),
                                   scores=scores[f])
        assert torch.equal(got.inlier_mask[f], one.inlier_mask)


# --------------------------------------------------------------------------- #
# Doppler-azimuth responses (TPU kernels #4-#6)
# --------------------------------------------------------------------------- #
def _spectra(b, n_ch, w, nv, av, n_cols, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n_ch, w * nv)).astype(np.float32),
            rng.standard_normal((b, n_ch, w * nv)).astype(np.float32),
            rng.uniform(0, 1, (b, w)).astype(np.float32),
            rng.standard_normal((av, n_cols)).astype(np.float32),
            rng.standard_normal((av, n_cols)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_responses_close(got, want):
    """Mosaic in interpret mode contracts and orders the sums its own way: 1e-5."""
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 12, 5, 16, 9), (2, 12, 19, 70, 60)],
                         ids=["small", "flagship"])
def test_set_responses_equal_batch_kernel_4(shape):
    args = _spectra(*shape, n_cols=16, seed=shape[0])
    want = jdoppler_az.set_responses_pallas_batch(*args, set_idx=SETS, nv=shape[3],
                                                  interpret=True)
    got = doppler_az.set_responses(*_t(*args), set_idx=SETS, nv=shape[3])
    assert got.shape == (shape[0], 4, shape[4], shape[3])
    _assert_responses_close(got.numpy(), want)


def test_set_responses_equal_single_frame_kernel_5_at_zoom_width():
    u_re, u_im, wgt, fct, fst = _spectra(1, 12, 19, 140, 60, n_cols=16, seed=7)
    want = jdoppler_az.set_responses_pallas(u_re[0], u_im[0], wgt[0], fct, fst,
                                            set_idx=SETS, nv=140, interpret=True)
    got = doppler_az.set_responses(*_t(u_re, u_im, wgt, fct, fst), set_idx=SETS,
                                   nv=140)
    _assert_responses_close(got[0].numpy(), want)


def _paired(u, set_idx, w, nv):
    """The paired layout of ``velocity_pipeline.py:412-415``: [B, 8, W*2nv]."""
    b = u.shape[0]
    g = u.reshape(b, -1, w, nv)[:, np.asarray(set_idx)].reshape(b, 2, 2, 4, w, nv)
    return np.ascontiguousarray(np.moveaxis(g, 2, 4).reshape(b, 8, w * 2 * nv))


def test_group_responses_equal_paired_kernel_6_and_unpaired_layout():
    b, w, nv, av = 3, 6, 10, 16
    u_re, u_im, wgt, fct, fst = _spectra(b, 12, w, nv, av, n_cols=16, seed=11)
    # the two sets of a group share factors
    fct[:, 4:8], fct[:, 12:16] = fct[:, 0:4], fct[:, 8:12]
    fst[:, 4:8], fst[:, 12:16] = fst[:, 0:4], fst[:, 8:12]
    cols = (0, 1, 2, 3, 8, 9, 10, 11)
    p_re, p_im = _paired(u_re, SETS, w, nv), _paired(u_im, SETS, w, nv)
    g_fct, g_fst = np.ascontiguousarray(fct[:, cols]), np.ascontiguousarray(fst[:, cols])
    want = jdoppler_az.group_responses_pallas_batch(
        p_re, p_im, wgt, g_fct, g_fst, n_groups=2, n_rx=4, nv2=2 * nv,
        interpret=True)
    got = doppler_az.group_responses(*_t(p_re, p_im, wgt, g_fct, g_fst),
                                     n_groups=2, n_rx=4, nv2=2 * nv)
    assert got.shape == (b, 2, av, 2 * nv)
    _assert_responses_close(got.numpy(), want)
    # the paired layout against the unpaired one: the same arithmetic per
    # element (on the card bit for bit; PyTorch's CPU sqrt may take 1 ulp)
    unpaired = doppler_az.set_responses(*_t(u_re, u_im, wgt, fct, fst),
                                        set_idx=SETS, nv=nv).numpy()
    sets = np.stack([got[:, 0, :, :nv], got[:, 0, :, nv:], got[:, 1, :, :nv],
                     got[:, 1, :, nv:]], axis=1)
    np.testing.assert_allclose(sets, unpaired, rtol=4e-7, atol=0)
    assert doppler_az.group_set_idx(2, 4) == ((0, 1, 2, 3), (4, 5, 6, 7))


def test_plain_version_is_the_pallas_order_of_operations():
    """Against a numpy float32 replica of ``_kernel_batch``, op for op."""
    u_re, u_im, wgt, fct, fst = _spectra(2, 12, 4, 8, 5, n_cols=16, seed=12)
    want = np.zeros((2, 4, 5, 8), np.float32)
    ur, ui = u_re.reshape(2, 12, 4, 8), u_im.reshape(2, 12, 4, 8)
    for s in range(4):
        sp_re = sp_im = None
        for r in range(4):
            fc = fct[:, 4 * s + r][None, :, None, None]
            fs = fst[:, 4 * s + r][None, :, None, None]
            a, c = ur[:, None, SETS[s][r]], ui[:, None, SETS[s][r]]
            t_re, t_im = fc * a + fs * c, fc * c - fs * a
            sp_re = t_re if sp_re is None else sp_re + t_re
            sp_im = t_im if sp_im is None else sp_im + t_im
        mag = np.sqrt(sp_re * sp_re + sp_im * sp_im)
        acc = wgt[:, 0, None, None] * mag[:, :, 0]
        for w in range(1, 4):
            acc = acc + wgt[:, w, None, None] * mag[:, :, w]
        want[:, s] = acc
    got = doppler_az.set_responses_reference(*_t(u_re, u_im, wgt, fct, fst),
                                             set_idx=SETS, nv=8).numpy()
    # numpy's sqrt is IEEE; PyTorch's CPU sqrt may take 1 ulp
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=0)


def test_launch_counter_stays_zero_on_cpu():
    kernel.doppler_az_responses.launches = 0
    args = _t(*_spectra(2, 12, 3, 8, 5, n_cols=16, seed=13))
    doppler_az.set_responses(*args, set_idx=SETS, nv=8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.doppler_az_responses(*args, set_idx=SETS, nv=8)
    assert kernel.doppler_az_responses.launches == 0


@pytest.mark.parametrize("case", ["float64", "nv", "wgt", "factors", "channel",
                                  "ragged", "meta", "table", "cpu"])
def test_responses_reject_what_they_do_not_take(case):
    """The dispatch and the launch both raise, never fall back."""
    u_re, u_im, wgt, fct, fst = _t(*_spectra(2, 12, 3, 8, 5, n_cols=16, seed=14))
    call = dict(set_idx=SETS, nv=8)
    err, match = ValueError, None
    if case == "float64":
        u_re, err, match = u_re.double(), TypeError, "float32"
    elif case == "nv":
        call["nv"], match = 7, "multiple of nv"
    elif case == "wgt":
        wgt, match = wgt[:, :2], "wgt"
    elif case == "factors":
        fct, match = fct[:, :12], "fct/fst"
    elif case == "channel":
        call["set_idx"], match = ((0, 1, 2, 12),) * 4, "out of range"
    elif case == "ragged":
        call["set_idx"], match = ((0, 1, 2), (0, 1, 2, 3)), "differ in length"
    elif case == "meta":
        u_re, u_im = u_re.to("meta"), u_im.to("meta")
        wgt, fct, fst = wgt.to("meta"), fct.to("meta"), fst.to("meta")
        match = "no response kernel for device"
    elif case == "table":  # more (set, antenna) pairs than the kernel takes
        with pytest.raises(ValueError, match="at most"):
            kernel.doppler_az_responses(u_re, u_im, wgt, fct, fst,
                                        set_idx=((0,) * 65,), nv=8)
        return
    else:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            kernel.doppler_az_responses(u_re, u_im, wgt, fct, fst, **call)
        return
    with pytest.raises(err, match=match):
        doppler_az.set_responses(u_re, u_im, wgt, fct, fst, **call)


def test_response_kernel_source_is_keyed_for_the_build():
    lib = _build.library_path("doppler_az_responses")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("doppler_az_responses-") and lib.suffix == ".so"
    assert (_build.CSRC_DIR / "doppler_az_responses.cu").is_file()


def test_peak_kernel_source_is_keyed_for_the_build():
    lib = _build.library_path("prominent_peak")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("prominent_peak-") and lib.suffix == ".so"
    source = (_build.CSRC_DIR / "prominent_peak.cu").read_text()
    # the wrapper refuses what the kernel's entry point would refuse
    assert f"constexpr int kMaxN = {peak_kernel.MAX_N};" in source


# --------------------------------------------------------------------------- #
# constants and zoom factors
# --------------------------------------------------------------------------- #
def test_velocity_sets_equal_jax():
    assert velocity_estimator.ODS_AZ_SETS_VIRTUAL == jvelocity.ODS_AZ_SETS_VIRTUAL
    assert velocity_estimator.ODS_EL_SETS_VIRTUAL == jvelocity.ODS_EL_SETS_VIRTUAL


def test_chirp_factors_equal_jax():
    c, s = dft.dft_factors(70, window=np.hanning(70), shift=True)
    w_c, w_s = mxu.dft_factors(70, window=np.hanning(70), shift=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(w_c))
    np.testing.assert_array_equal(s.numpy(), np.asarray(w_s))


def test_zoom_factors_match_jax_with_per_frame_bands():
    rng = np.random.default_rng(15)
    f1 = rng.uniform(-40, 0, 5).astype(np.float32)
    f2 = (f1 + rng.uniform(1, 10, 5)).astype(np.float32)
    kw = dict(n=70, m=70, fs=2 * 16.307, window=np.hanning(70))
    want = [jax.vmap(lambda a, b: mxu.zoom_dft_factors_dynamic(a, b, **kw)[i])(f1, f2)
            for i in (0, 1)]
    got = dft.zoom_dft_factors(torch.from_numpy(f1), torch.from_numpy(f2), **dict(
        kw, window=torch.from_numpy(np.hanning(70).astype(np.float32))))
    assert got[0].shape == (5, 70, 70)
    # float32 cos/sin of angles up to ~250 rad: the two libraries' cos and
    # sin may differ by an ulp of the angle's reduction
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5)
