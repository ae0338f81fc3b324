"""The RANSAC fit: dispatch, the kernel's wrapper, and the kernel on the card against the plain version.

``ops.ransac.ransac_linear`` runs ``ransac_linear_reference`` (the batched
PyTorch operations the tier-1 tests hold to the JAX package) on CPU tensors,
launches the hand-written kernel (``csrc/ransac_fit.cu``) on CUDA tensors
and raises on any other device.  Here, on the CPU:

- a CPU tensor takes the reference and launches nothing, whatever its shape;
- the wrapper refuses each shape the kernel declines (``D = 4``, rows past
  a block's shared memory, more trials than a block's warps) and each
  argument it does not take, before any build and before it looks at the
  device;
- the kernel source is keyed for the build, its limits the wrapper's.

On the card (the ``cuda`` marker; skipped without CUDA, and free of JAX so
that it runs with ``--noconftest``), the kernel against the reference on the
same CUDA tensors: inlier masks, ``ok`` and fractions equal, coefficients and
R^2 within ``RTOL`` (``ATOL`` near 0), one launch a call; what the kernel
does not take raises there and launches nothing.  Inputs are drawn
so that no valid row of any trial lies within ``MARGIN`` of the threshold
(:func:`_redraw_near_threshold`): there the two summation orders could
round a residual to either side.
"""

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch.ops import ransac
from mmwave_radar_processing_tpu_torch.ops.kernels import _build
from mmwave_radar_processing_tpu_torch.ops.kernels import ransac_fit as kernel
from mmwave_radar_processing_tpu_torch.point_cloud_processing import ego_vel_from_points

torch.set_num_threads(2)  # tier-1 runs several xdist workers

#: kernel against reference: float32 sums in another order
RTOL, ATOL = 1e-5, 1e-6
#: no valid row of any trial has | |residual| - threshold | below this (float64 trial fits)
MARGIN = 1e-4
MIN_SAMPLES, TRIALS = 10, 20


def _trial_near_threshold(h, y, valid, scores, thr, k):
    """Per fit: whether a valid row of a trial lies within ``MARGIN`` of the threshold.

    The trials' samples exactly as both versions take them (the k-th largest
    valid score, ties in), their ridged solves in float64.
    """
    h, y = h.astype(np.float64), y.astype(np.float64)
    s = np.where(valid[:, None, :], scores, -np.inf)
    kth = -np.sort(-s, axis=-1)[..., k - 1:k]
    w = ((s >= kth) & valid[:, None, :]).astype(np.float64)
    a = np.einsum("ftn,fnd,fne->ftde", w, h, h)
    b = np.einsum("ftn,fnd,fn->ftd", w, h, y)
    d = h.shape[-1]
    trace = np.trace(a, axis1=-2, axis2=-1)
    a = a + (1e-7 * (trace / d + 1e-30))[..., None, None] * np.eye(d)
    c = np.linalg.solve(a, b[..., None])[..., 0]
    r = y[:, None, :] - np.einsum("fnd,ftd->ftn", h, c)
    near = (np.abs(np.abs(r) - thr.reshape(-1, 1, 1)) < MARGIN) & valid[:, None, :]
    return near.any(axis=(1, 2))


def _redraw_near_threshold(draw, thr, k, rng, rounds=50):
    """``draw(rng, fits)`` -> ``(h, y, valid, scores)``; fits near the threshold drawn again."""
    h, y, valid, scores = draw(rng, None)
    flat = thr.reshape(-1)
    for _ in range(rounds):
        lead = h.shape[:-2]
        near = _trial_near_threshold(h.reshape(-1, *h.shape[-2:]), y.reshape(-1, y.shape[-1]),
                                     valid.reshape(-1, valid.shape[-1]),
                                     scores.reshape(-1, *scores.shape[-2:]), flat, k)
        if not near.any():
            return h, y, valid, scores
        idx = np.flatnonzero(near)
        nh, ny, nv, ns = draw(rng, len(idx))
        for arr, new in ((h, nh), (y, ny), (valid, nv), (scores, ns)):
            arr.reshape(-1, *arr.shape[len(lead):])[idx] = new.reshape(
                -1, *arr.shape[len(lead):])
    raise AssertionError("could not draw fits clear of the threshold")


def _gumbel(rng, shape):
    u = np.maximum(rng.random(shape), np.finfo(np.float32).tiny)
    return (-np.log(-np.log(u))).astype(np.float32)


def _lines(rng, lead, n, d, valid_rows, outliers=0.3, noise=0.05):
    """``(h, y, valid, scores)``: lines through 0 with noise and outliers, ``valid_rows`` (lo, hi) a fit."""
    if d == 3:  # unit directions over a hemisphere, as a point cloud's
        v = rng.normal(size=(*lead, n, 3))
        v[..., 2] = -np.abs(v[..., 2])
        h = v / np.linalg.norm(v, axis=-1, keepdims=True)
    else:
        h = rng.uniform(-1.0, 1.0, (*lead, n, d))
    coef = rng.normal(0.0, 1.0, (*lead, d))
    y = np.einsum("...nd,...d->...n", h, coef) + rng.normal(0.0, noise, (*lead, n))
    wild = rng.random((*lead, n)) < outliers
    y = np.where(wild, rng.uniform(-3.0, 3.0, (*lead, n)), y)
    counts = rng.integers(valid_rows[0], valid_rows[1] + 1, (*lead, 1))
    order = rng.random((*lead, n)).argsort(axis=-1)  # valid rows at random positions
    valid = order < counts
    return (h.astype(np.float32), y.astype(np.float32), valid,
            _gumbel(rng, (*lead, TRIALS, n)))


def _case(name, seed=0):
    """``(h, y, valid, scores, threshold)`` of a case, as numpy arrays (threshold a float or an array)."""
    rng = np.random.default_rng(seed)
    outliers = 0.3
    if name == "d1_per_fit_threshold":  # the velocity path's fits: [B, 2] at 0.15 or 0.20
        lead, n, d, rows = (64, 2), 70, 1, (20, 70)
        thr = np.where(rng.random(lead) < 0.5, 0.15, 0.20).astype(np.float32)
    elif name == "d3_point_cloud":  # the velocity analysis's: 512 slots, 80-130 filled
        lead, n, d, rows, thr = (64,), 512, 3, (80, 130), 0.15
    elif name == "d2_few_valid":  # some fits with fewer valid rows than min_samples; no
        # outlier, so a fit that is ok refits on every row, not on a rank-deficient few
        lead, n, d, rows, thr, outliers = (64,), 70, 2, (0, 14), 0.15, 0.0
    elif name == "d3_no_valid_row":
        lead, n, d, rows, thr = (8,), 40, 3, (0, 0), 0.15
    elif name == "d1_rows_below_min_samples":  # N < min_samples: k = N
        lead, n, d, rows, thr = (16,), 8, 1, (5, 8), 0.15
    elif name == "d1_every_row_an_inlier":
        lead, n, d, rows, thr = (16,), 70, 1, (30, 70), 50.0
    else:
        raise KeyError(name)
    thr_arr = np.broadcast_to(np.float32(thr), lead)
    k = min(MIN_SAMPLES, n)

    def draw(g, fits):
        return _lines(g, lead if fits is None else (fits,), n, d, rows, outliers)

    h, y, valid, scores = _redraw_near_threshold(draw, thr_arr, k, rng)
    return h, y, valid, scores, thr


def _tied_scores(seed=1):
    """3D fits whose scores take a few values: the k-th ties with others, and every tie is sampled."""
    def draw(g, fits):
        h, y, valid, scores = _lines(g, (64,) if fits is None else (fits,), 512, 3, (80, 130))
        return h, y, valid, np.round(scores * 2.0) / 2.0

    h, y, valid, scores = _redraw_near_threshold(draw, np.full(64, 0.15, np.float32),
                                                 MIN_SAMPLES, np.random.default_rng(seed))
    return h, y, valid, scores, 0.15


def _tied_key(fits=8, seed=5):
    """Two lines of 40 rows each: even trials sample line A (noisy), odd ones line B (exact).

    Every trial counts 40 inliers, so ``40e6 + r2 + t*1e-9`` rounds to one
    float32 value and the first trial (line A) must win, though B's R^2 is
    higher.
    """
    rng = np.random.default_rng(seed)
    n_half = 40
    x = np.concatenate([np.linspace(0.5, 2.0, n_half)] * 2)
    h = np.broadcast_to(x[:, None], (fits, 2 * n_half, 1)).astype(np.float32).copy()
    y = np.concatenate([np.broadcast_to(x[:n_half], (fits, n_half))
                        + rng.normal(0, 0.02, (fits, n_half)),
                        np.broadcast_to(-x[n_half:], (fits, n_half))], axis=1).astype(np.float32)
    valid = np.ones((fits, 2 * n_half), bool)
    scores = np.full((fits, TRIALS, 2 * n_half), -1.0, np.float32)
    for t in range(TRIALS):
        half = slice(0, n_half) if t % 2 == 0 else slice(n_half, None)
        scores[:, t, half] = rng.uniform(0.0, 1.0, (fits, n_half))
    return h, y, valid, scores, 0.15


def _torch(case, device="cpu"):
    h, y, valid, scores, thr = case
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    thr = to(np.asarray(thr, np.float32)) if isinstance(thr, np.ndarray) else thr
    return to(h), to(y), to(valid), to(scores), thr


def _fit(fn, h, y, valid, scores, thr, trials=TRIALS):
    return fn(h, y, valid, min_samples=MIN_SAMPLES, residual_threshold=thr, max_trials=trials,
              scores=scores)


# --------------------------------------------------------------------------- #
# CPU: dispatch and the wrapper
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["d1_per_fit_threshold", "d3_point_cloud", "d2_few_valid"])
def test_a_cpu_tensor_takes_the_reference_and_launches_nothing(name):
    args = _torch(_case(name))
    before = kernel.ransac_fit.launches
    got = _fit(ransac.ransac_linear, *args)
    assert kernel.ransac_fit.launches == before
    want = _fit(ransac.ransac_linear_reference, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _declined(shape):
    """``(h, y, valid, scores, trials)`` of a shape the kernel does not take."""
    rng = np.random.default_rng(3)
    fits, n, d, trials = {"d4": (3, 40, 4, TRIALS),
                          "rows_past_shared_memory": (2, 1700, 3, kernel.MAX_TRIALS),
                          "rows_past_the_limit": (1, kernel.MAX_ROWS + 1, 1, 2),
                          "trials_past_the_warps": (3, 40, 3, kernel.MAX_TRIALS + 1)}[shape]
    h = rng.uniform(-1, 1, (fits, n, d)).astype(np.float32)
    y = (h.sum(-1) + rng.normal(0, 0.05, (fits, n))).astype(np.float32)
    valid = rng.random((fits, n)) < 0.8
    scores = _gumbel(rng, (fits, trials, n))
    return (torch.from_numpy(h), torch.from_numpy(y), torch.from_numpy(valid),
            torch.from_numpy(scores), trials)


DECLINED = ["d4", "rows_past_shared_memory", "rows_past_the_limit", "trials_past_the_warps"]


@pytest.mark.parametrize("shape", DECLINED)
def test_a_declined_shape_takes_the_reference(shape):
    """On the CPU any shape is the reference's; the wrapper refuses it."""
    h, y, valid, scores, trials = _declined(shape)
    n, d = h.shape[-2:]
    assert not kernel.takes(n, d, trials)
    before = kernel.ransac_fit.launches
    got = _fit(ransac.ransac_linear, h, y, valid, scores, 0.15, trials)
    assert kernel.ransac_fit.launches == before
    want = _fit(ransac.ransac_linear_reference, h, y, valid, scores, 0.15, trials)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got.ok.all() and (got.r2 > 0.5).all()
    # the wrapper refuses it before any build
    with pytest.raises(ValueError, match="the RANSAC kernel takes"):
        kernel.ransac_fit(h, y, valid, scores, 0.15, min_samples=MIN_SAMPLES)


def test_the_cells_shapes_are_taken():
    # the velocity analysis (512 slots, 3D) and the velocity path ([B, 2] fits of 70 rows, 1D)
    assert kernel.takes(512, 3, 20) and kernel.takes(70, 1, 20)
    assert kernel.shared_bytes(512, 3, 20) == 4 * (2 * 16 + 24 * 512 + 20 * 16 + 20)
    assert kernel.shared_bytes(512, 3, 20) > 48 * 1024  # granted above the default
    assert kernel.takes(kernel.MAX_ROWS, 1, 2) and not kernel.takes(kernel.MAX_ROWS, 3, 32)


ARGUMENTS = {"threshold_not_broadcast": (ValueError, "broadcastable to"),
             "threshold_longer": (ValueError, "broadcastable to"),
             "min_samples_0": (ValueError, "min_samples >= 1"),
             "float64_scores": (TypeError, "takes torch.float32 scores"),
             "valid_not_bool": (TypeError, "takes torch.bool valid")}


def _argument(what, device="cpu"):
    """``(h, y, valid, scores, threshold, min_samples)`` with one argument the kernel does not take."""
    h, y, valid, scores, thr = _torch(_case("d1_per_fit_threshold"), device)
    min_samples = MIN_SAMPLES
    if what == "threshold_not_broadcast":
        thr = thr[:, :1].expand(64, 3)
    elif what == "threshold_longer":
        thr = thr[None]
    elif what == "min_samples_0":
        min_samples = 0
    elif what == "float64_scores":
        scores = scores.double()
    else:
        valid = valid.to(torch.uint8)
    return h, y, valid, scores, thr, min_samples


@pytest.mark.parametrize("what", sorted(ARGUMENTS))
def test_the_wrapper_refuses_arguments_the_kernel_does_not_take(what):
    """Refused on the CPU too: the arguments are checked before the device."""
    h, y, valid, scores, thr, min_samples = _argument(what)
    err, match = ARGUMENTS[what]
    before = kernel.ransac_fit.launches
    with pytest.raises(err, match=match):
        kernel.ransac_fit(h, y, valid, scores, thr, min_samples=min_samples)
    assert kernel.ransac_fit.launches == before


def test_another_device_raises():
    h, y, valid, scores, thr = (t.to("meta") if isinstance(t, torch.Tensor) else t
                                for t in _torch(_case("d1_per_fit_threshold")))
    with pytest.raises(ValueError, match="no RANSAC kernel for device meta"):
        _fit(ransac.ransac_linear, h, y, valid, scores, thr)


@pytest.mark.parametrize("what", ["cpu", "min_samples_0"])
def test_the_wrapper_refuses_a_cpu_tensor_and_min_samples_0(what):
    h, y, valid, scores, thr = _torch(_case("d1_per_fit_threshold"))
    before = kernel.ransac_fit.launches
    match = "needs a CUDA tensor" if what == "cpu" else "min_samples >= 1"
    with pytest.raises(ValueError, match=match):
        kernel.ransac_fit(h, y, valid, scores, thr, min_samples=0 if what != "cpu" else 10)
    assert kernel.ransac_fit.launches == before


def test_kernel_source_is_keyed_for_the_build():
    lib = _build.library_path("ransac_fit")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("ransac_fit-") and lib.suffix == ".so"
    source = (_build.CSRC_DIR / "ransac_fit.cu").read_text()
    # the wrapper refuses what the kernel's entry point would refuse
    assert f"constexpr int kMaxTrials = {kernel.MAX_TRIALS};" in source
    assert f"constexpr int kMaxFeatures = {kernel.MAX_FEATURES};" in source
    assert f"constexpr int kMaxRows = {kernel.MAX_ROWS};" in source
    assert kernel.MAX_SHARED_BYTES == 227 * 1024
    assert "constexpr int kMaxSharedBytes = 227 * 1024;" in (
        _build.CSRC_DIR / "launch_helpers.cuh").read_text()


@pytest.mark.parametrize("name", ["d1_per_fit_threshold", "d3_point_cloud", "tied_scores"])
def test_the_cases_keep_clear_of_the_threshold(name):
    """The drawn inputs hold what the card's comparison assumes (checked in float64 here)."""
    h, y, valid, scores, thr = _tied_scores() if name == "tied_scores" else _case(name)
    thr = np.broadcast_to(np.float32(thr), h.shape[:-2]).reshape(-1)
    near = _trial_near_threshold(h.reshape(-1, *h.shape[-2:]), y.reshape(-1, y.shape[-1]),
                                 valid.reshape(-1, valid.shape[-1]),
                                 scores.reshape(-1, *scores.shape[-2:]), thr, MIN_SAMPLES)
    assert not near.any()
    if name == "tied_scores":  # the k-th score ties with another on most trials
        s = np.where(valid[:, None, :], scores, -np.inf)
        kth = -np.sort(-s, axis=-1)[..., MIN_SAMPLES - 1:MIN_SAMPLES]
        sampled = ((s >= kth) & valid[:, None, :]).sum(-1)
        assert (sampled > MIN_SAMPLES).mean() > 0.5


def test_the_reference_lets_the_first_trial_win_a_tied_key():
    got = _fit(ransac.ransac_linear, *_torch(_tied_key()))
    assert got.inlier_mask[:, :40].all() and not got.inlier_mask[:, 40:].any()


# --------------------------------------------------------------------------- #
# the kernel on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


CASES = ["d1_per_fit_threshold", "d3_point_cloud", "d2_few_valid", "d3_no_valid_row",
         "d1_rows_below_min_samples", "d1_every_row_an_inlier", "tied_scores", "tied_key"]


def _assert_kernel_equals_reference(args):
    before = kernel.ransac_fit.launches
    got = _fit(ransac.ransac_linear, *args)
    torch.cuda.synchronize()
    assert kernel.ransac_fit.launches == before + 1
    want = _fit(ransac.ransac_linear_reference, *args)
    assert torch.equal(got.inlier_mask, want.inlier_mask)
    assert torch.equal(got.ok, want.ok)
    assert torch.equal(got.inlier_fraction, want.inlier_fraction)
    for name in ("coef", "r2"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=RTOL, atol=ATOL,
                                   msg=name)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_the_kernel_equals_the_reference(cuda, name):
    case = {"tied_scores": _tied_scores, "tied_key": _tied_key}.get(name, lambda: _case(name))()
    got = _assert_kernel_equals_reference(_torch(case, cuda))
    if name in ("d3_no_valid_row", "d1_rows_below_min_samples"):
        assert not got.ok.any() and not got.coef.any() and not got.inlier_mask.any()
    elif name == "d2_few_valid":
        assert not got.ok.all() and got.ok.any()
    elif name == "d1_every_row_an_inlier":
        valid = _torch(case, cuda)[2]
        assert torch.equal(got.inlier_mask, valid & got.ok[:, None])
    elif name == "tied_key":
        assert got.inlier_mask[:, :40].all() and not got.inlier_mask[:, 40:].any()


@pytest.mark.cuda
def test_fit_vy_threshold_broadcasts_on_the_card(cuda):
    h, y, valid, scores, thr = _torch(_case("d1_per_fit_threshold"), cuda)
    _assert_kernel_equals_reference((h, y, valid, scores, thr[:, :1]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECLINED)
def test_a_declined_shape_raises_on_the_card(cuda, shape):
    h, y, valid, scores, trials = (a.to(cuda) if isinstance(a, torch.Tensor) else a
                                   for a in _declined(shape))
    before = kernel.ransac_fit.launches
    with pytest.raises(ValueError, match="the RANSAC kernel takes"):
        _fit(ransac.ransac_linear, h, y, valid, scores, 0.15, trials)
    assert kernel.ransac_fit.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("what", sorted(ARGUMENTS))
def test_arguments_the_kernel_does_not_take_raise_on_the_card(cuda, what):
    h, y, valid, scores, thr, min_samples = _argument(what, cuda)
    err, match = ARGUMENTS[what]
    before = kernel.ransac_fit.launches
    with pytest.raises(err, match=match):
        ransac.ransac_linear(h, y, valid, min_samples=min_samples, residual_threshold=thr,
                             max_trials=TRIALS, scores=scores)
    assert kernel.ransac_fit.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["float64_h", "not_contiguous", "threshold_shape",
                                  "valid_shape"])
def test_the_wrapper_refuses_on_the_card_what_the_kernel_does_not_take(cuda, what):
    h, y, valid, scores, thr = _torch(_case("d1_per_fit_threshold"), cuda)
    err = ValueError
    if what == "float64_h":
        h, err, match = h.double(), TypeError, "takes torch.float32 h"
    elif what == "not_contiguous":
        h, match = h.transpose(0, 1).contiguous().transpose(0, 1), "contiguous h"
    elif what == "threshold_shape":
        thr, match = thr[:, None], "broadcastable to"
    else:
        valid, match = valid[..., :-1].contiguous(), "expected valid of shape"
    before = kernel.ransac_fit.launches
    with pytest.raises(err, match=match):
        kernel.ransac_fit(h, y, valid, scores, thr, min_samples=MIN_SAMPLES)
    assert kernel.ransac_fit.launches == before


@pytest.mark.cuda
def test_one_launch_a_points_fit_on_the_card(cuda):
    h, y, valid, scores, _ = _case("d3_point_cloud")
    points = np.concatenate([h * 2.0, -y[..., None]], axis=-1)  # the fit is -vel = (p/|p|) . v
    args = dict(dims=3, scores=torch.from_numpy(scores).to(cuda))
    before = kernel.ransac_fit.launches
    got = ego_vel_from_points(torch.from_numpy(points).to(cuda), torch.from_numpy(valid).to(cuda),
                              **args)
    assert kernel.ransac_fit.launches == before + 1
    want = ego_vel_from_points(torch.from_numpy(points), torch.from_numpy(valid),
                               **{**args, "scores": args["scores"].cpu()})
    assert torch.equal(got.inlier_mask.cpu(), want.inlier_mask)
    torch.testing.assert_close(got.coef.cpu(), want.coef, rtol=RTOL, atol=ATOL)
