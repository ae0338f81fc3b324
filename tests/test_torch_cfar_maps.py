"""The port's CFAR threshold maps against the JAX package's, on the same seeded inputs.

Tolerances, each with its reason:

- OS thresholds and noise are **equal**: a k-th smallest is one of the
  inputs, and ``alpha * noise`` is one float32 product on both sides.
- CA/GO/SO noise and thresholds agree within ``SUM_RTOL`` = 1e-5: a float32
  sum over up to 220 training cells, taken in another order.  Their
  detection masks are equal except at cells within that band of the
  threshold.
- The plain versions of the two rank-selection kernels equal the JAX
  package's Pallas kernels run in interpret mode, exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
from mmwave_radar_processing_tpu.ops import cfar as jcfar
from mmwave_radar_processing_tpu.ops.pallas.os_cfar import os_cfar_2d_noise_fused
from mmwave_radar_processing_tpu.ops.pallas.rank_select import kth_smallest
from mmwave_radar_processing_tpu_torch.ops import cfar

torch.set_num_threads(2)

SUM_RTOL = 1e-5

CA_1D = dict(num_train=8, num_guard=3, pfa=1e-3)
GO_1D = dict(num_train=6, num_guard=2, pfa=1e-3, greatest=True)
SO_1D = dict(num_train=6, num_guard=2, pfa=1e-3, greatest=False)
OS_1D = dict(num_train=5, num_guard=3, rho=0.5, alpha=2.0)
OS_1D_GROUND = dict(num_train=12, num_guard=4, rho=0.5, alpha=15.0)
CA_2D = dict(num_train=(5, 5), num_guard=(3, 2), pfa=1e-3)
OS_2D = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
OS_2D_SECOND = dict(num_train=(4, 6), num_guard=(2, 1), rho=0.5, alpha=3.0)
OS_2D_ZERO_GUARD = dict(num_train=(3, 2), num_guard=(0, 0), rho=0.5, alpha=2.0)

CASES_1D = [("ca_1d", CA_1D), ("go_so_1d", GO_1D), ("go_so_1d", SO_1D), ("os_1d", OS_1D),
            ("os_1d", OS_1D_GROUND)]
CASES_2D = [("ca_2d", CA_2D), ("ca_2d", dict(num_train=(2, 0), num_guard=(0, 3), pfa=1e-2)),
            ("os_2d", OS_2D), ("os_2d", OS_2D_SECOND), ("os_2d", OS_2D_ZERO_GUARD)]
IDS_1D = ["ca", "go", "so", "os", "os_ground"]
IDS_2D = ["ca", "ca_no_col_train", "os", "os_second", "os_zero_guard"]


def quantized(shape, seed):
    """Exponential magnitudes rounded to 1/8: many exact ties within a window."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.exponential(1.0, shape) * 8) / 8).astype(np.float32)


def assert_maps_agree(name, x, got, want):
    """Thresholds and noise per the module's bars; masks equal off the threshold's band."""
    thr, noise = (t.numpy() for t in got)
    thr_j, noise_j = (np.asarray(a) for a in want)
    assert thr.shape == thr_j.shape == x.shape and thr.dtype == np.float32
    if name.startswith("os"):
        np.testing.assert_array_equal(thr, thr_j)
        np.testing.assert_array_equal(noise, noise_j)
        np.testing.assert_array_equal(x > thr, x > thr_j)
        return
    np.testing.assert_array_equal(np.isinf(thr), np.isinf(thr_j))
    finite = np.isfinite(thr_j)
    np.testing.assert_allclose(thr[finite], thr_j[finite], rtol=SUM_RTOL, atol=0)
    np.testing.assert_allclose(noise, noise_j, rtol=SUM_RTOL, atol=0)
    differ = (x > thr) != (x > thr_j)
    assert np.all(np.abs(x - thr_j)[differ] <= SUM_RTOL * thr_j[differ])


@pytest.mark.parametrize("shape", [(70,), (5, 63), (2, 3, 70)], ids=["1d", "batch", "batch2"])
@pytest.mark.parametrize("name,kw", CASES_1D, ids=IDS_1D)
def test_threshold_maps_1d_match_jax(name, kw, shape):
    x = quantized(shape, seed=len(shape))
    got = getattr(cfar, name)(torch.from_numpy(x), **kw)
    assert_maps_agree(name, x, got, getattr(jcfar, name)(x, **kw))
    assert np.isfinite(got[0].numpy()).any()


@pytest.mark.parametrize("shape", [(63, 70), (3, 40, 36), (2, 2, 30, 33)],
                         ids=["2d", "batch", "batch2"])
@pytest.mark.parametrize("name,kw", CASES_2D, ids=IDS_2D)
def test_threshold_maps_2d_match_jax(name, kw, shape):
    x = quantized(shape, seed=10 + len(shape))
    got = getattr(cfar, name)(torch.from_numpy(x), **kw)
    assert_maps_agree(name, x, got, getattr(jcfar, name)(x, **kw))
    assert np.isfinite(got[0].numpy()).any()


def test_os_2d_batch_above_the_sort_chunk_matches_jax():
    x = quantized((cfar._SORT_BATCH_CHUNK + 3, 20, 18), seed=4)
    kw = dict(num_train=(2, 2), num_guard=(1, 1), rho=0.6, alpha=3.0)
    assert_maps_agree("os_2d", x, cfar.os_2d(torch.from_numpy(x), **kw), jcfar.os_2d(x, **kw))


@pytest.mark.parametrize("name,kw", CASES_1D + CASES_2D, ids=IDS_1D + [f"{i}_2d" for i in IDS_2D])
def test_signal_shorter_than_a_window_is_all_inf_and_zero(name, kw):
    x = torch.from_numpy(quantized((3, 4, 4), seed=1))
    thr, noise = getattr(cfar, name)(x, **kw)
    assert thr.shape == x.shape and bool(torch.isinf(thr).all()) and bool((noise == 0).all())
    thr_j, noise_j = getattr(jcfar, name)(x.numpy(), **kw)
    np.testing.assert_array_equal(thr.numpy(), np.asarray(thr_j))


@pytest.mark.parametrize("name,kw", [("os_1d", OS_1D), ("os_2d", OS_2D), ("ca_2d", CA_2D)])
def test_signal_of_exactly_one_window(name, kw):
    shape = (2, 17) if name == "os_1d" else (2, 17, 15)
    x = quantized(shape, seed=6)
    got = getattr(cfar, name)(torch.from_numpy(x), **kw)
    assert int(torch.isfinite(got[0]).sum()) == 2
    assert_maps_agree(name, x, got, getattr(jcfar, name)(x, **kw))


@pytest.mark.parametrize("kw", [OS_1D, OS_1D_GROUND], ids=["os", "os_ground"])
@pytest.mark.parametrize("shape", [(70,), (4, 63), (3,)], ids=["1d", "batch", "short"])
def test_os_1d_detect_matches_jax_and_the_threshold_form(kw, shape):
    x = quantized(shape, seed=8)
    got = cfar.os_1d_detect(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcfar.os_1d_detect(x, **kw)))
    np.testing.assert_array_equal(got, x > cfar.os_1d(torch.from_numpy(x), **kw)[0].numpy())


@pytest.mark.parametrize("kw", [OS_2D, OS_2D_SECOND, OS_2D_ZERO_GUARD],
                         ids=["flagship", "second", "zero_guard"])
def test_threshold_compare_equals_counting_detection(kw):
    """``x > os_2d(x)`` is ``os_2d_detect(x)``: the identity the two kernels check each other by."""
    x = torch.from_numpy(quantized((3, 40, 36), seed=9))
    assert torch.equal(x > cfar.os_2d(x, **kw)[0], cfar.os_2d_detect(x, **kw))
    assert bool(cfar.os_2d_detect(x, **kw).any())


@pytest.mark.parametrize("kw", [OS_2D, OS_2D_SECOND, OS_2D_ZERO_GUARD,
                                dict(num_train=(2, 4), num_guard=(1, 0), rho=0.9, alpha=1.0)],
                         ids=["flagship", "second", "zero_guard", "row_guard"])
@pytest.mark.parametrize("shape", [(24, 22), (3, 24, 22)], ids=["map", "batch"])
def test_noise_plain_version_equals_pallas_kernel_in_interpret_mode(kw, shape):
    x = quantized(shape, seed=12)
    geometry = dict(num_train=kw["num_train"], num_guard=kw["num_guard"])
    k = cfar._geometry(kw["num_train"], kw["num_guard"], kw["rho"])[3]
    got = cfar.os_2d_noise_reference(torch.from_numpy(x), k=k, **geometry)
    want = os_cfar_2d_noise_fused(x, k_rank=k, interpret=True, **geometry)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,ks", [((500, 152), (1, 77, 106, 152)), ((7, 1), (1,)),
                                      ((33, 10), (1, 7, 10)), ((33, 24), (12,)),
                                      ((3, 220), (154,)), ((5, 257), (1, 200, 257))],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v[0], int) and
                         len(v) == 2 else None)
def test_kth_plain_version_equals_pallas_kernel_in_interpret_mode(shape, ks):
    x = quantized(shape, seed=shape[1]) - 0.5
    x[0, ::2] = np.inf
    for k in ks:
        got = cfar.kth_smallest_reference(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(kth_smallest(x, k, interpret=True)))
        assert torch.equal(cfar._rank_reduce(torch.from_numpy(x), k), got)


def test_rank_reduce_keeps_leading_dimensions():
    x = torch.from_numpy(quantized((2, 3, 9), seed=2))
    assert torch.equal(cfar._rank_reduce(x, 4), torch.sort(x, dim=-1).values[..., 3])


@pytest.mark.parametrize("method", ["sort", "pallas", "xla"])
def test_method_selectors_raise(method):
    x = torch.from_numpy(quantized((20, 20), seed=0))
    with pytest.raises(ValueError, match="device decides"):
        cfar.os_2d(x, **OS_2D, method=method)
    with pytest.raises(ValueError, match="device decides"):
        cfar._rank_reduce(x, 3, method=method)


@pytest.mark.parametrize("k", [0, 21])
def test_rank_out_of_range_raises(k):
    with pytest.raises(ValueError, match="outside"):
        cfar._rank_reduce(torch.zeros(4, 20), k)


@pytest.mark.parametrize("name,kw", [("ca_1d", CA_1D), ("os_1d", OS_1D), ("ca_2d", CA_2D),
                                     ("os_2d", OS_2D), ("os_1d_detect", OS_1D)])
def test_float64_signals_are_rejected(name, kw):
    with pytest.raises(TypeError, match="float32"):
        getattr(cfar, name)(torch.zeros(40, 40, dtype=torch.float64), **kw)


def test_alpha_ca_matches_jax():
    for n, pfa in ((16, 1e-3), (220, 1e-4), (6, 1e-2)):
        assert cfar.alpha_ca(n, pfa) == jcfar.alpha_ca(n, pfa)
    assert cfar.os_rank(0.7, 220) == jcfar.os_rank(0.7, 220) == 154
