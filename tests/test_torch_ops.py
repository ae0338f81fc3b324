"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function (on the
CPU, Pallas kernels in interpret mode) and its port.  Constants and discrete
decisions (CFAR masks, compaction) must be bit-exact; float stages agree to
a tolerance stated with its reason.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmwave_radar_processing_tpu.ops import cfar as jcfar
from mmwave_radar_processing_tpu.ops import masked as jmasked
from mmwave_radar_processing_tpu.ops import mxu
from mmwave_radar_processing_tpu.ops import windows as jwindows
from mmwave_radar_processing_tpu.processors import point_cloud as jpoint_cloud
from mmwave_radar_processing_tpu.processors.virtual_array import reformat as jreformat
from mmwave_radar_processing_tpu.config import grids
from mmwave_radar_processing_tpu_torch.ops import cfar, dft, masked, windows
from mmwave_radar_processing_tpu_torch.ops.kernels import _build
from mmwave_radar_processing_tpu_torch.ops.kernels import os_cfar as kernel
from mmwave_radar_processing_tpu_torch.processors.point_cloud import (
    spherical_to_cartesian_flu,
)
from mmwave_radar_processing_tpu_torch.processors.virtual_array import reformat

torch.set_num_threads(2)  # tier-1 runs several xdist workers

FLAGSHIP = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
SECOND = dict(num_train=(4, 6), num_guard=(2, 1), rho=0.5, alpha=3.0)
UNION = (0, 3, 4, 5, 7, 8, 9)  # the flagship AoA union (channel 0 included)


def _raw(batch, seed):
    rng = np.random.default_rng(seed)
    shape = (batch, 4, 63, 210)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _quantized_maps(shape, seed):
    """Exponential magnitudes rounded to 1/8, as tests/test_ops.py: ties forced."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.exponential(1.0, shape) * 8) / 8).astype(np.float32)


def _complex(re, im):
    return torch.complex(torch.from_numpy(np.array(re)),
                         torch.from_numpy(np.array(im)))


def _assert_close_rel(got, want):
    """DFT sums run in another order: rtol 1e-5, atol 1e-5 of the largest |value|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------------------- #
# constants
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("m", [63, 70, 16])
def test_hanning_equals_jax(m):
    np.testing.assert_array_equal(windows.hanning(m), jwindows.hanning(m))
    np.testing.assert_array_equal(windows.hanning(m, np.float64), np.hanning(m))


@pytest.mark.parametrize("which", ["range", "doppler", "az", "el", "zoom"])
def test_dft_factors_equal_jax(which):
    rng_t, dop_t = dft.range_doppler_factors(63, 70)
    rng_j, dop_j = mxu.range_doppler_factors(63, 70)
    got, want = {
        "range": (rng_t, rng_j),
        "doppler": (dop_t, dop_j),
        "az": (dft.aoa_factors(4, 64, True), mxu.aoa_factors(4, 64, True)),
        "el": (dft.aoa_factors(4, 64, False), mxu.aoa_factors(4, 64, False)),
        "zoom": (dft.dft_factors(16, 40, shift=True, window=np.hanning(16)),
                 mxu.dft_factors(16, 40, shift=True, window=np.hanning(16))),
    }[which]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m = dft.to_matrix(got)
    np.testing.assert_array_equal(m.real.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(m.imag.numpy(), -np.asarray(want[1]))


@pytest.mark.parametrize("az, el", [((0, 3, 4, 7), (9, 8, 5, 4)),
                                    ((3, 4, 7), (9, 8, 5)),
                                    ((0, 3), ())])
def test_aoa_union_layout_equals_jax(az, el):
    for g, w in zip(dft.aoa_union_layout(az, el), mxu.aoa_union_layout(az, el)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --------------------------------------------------------------------------- #
# spectral stages
# --------------------------------------------------------------------------- #
def test_reformat_equals_jax():
    re, im = _raw(2, seed=0)
    got = reformat(_complex(re, im), num_rx=4, cfgs_per_loop=3)
    want = jreformat(jnp.asarray(re + 1j * im), num_rx=4, cfgs_per_loop=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_range_dft_channels_matches_jax():
    re, im = _raw(3, seed=1)
    rng_f, _ = mxu.range_doppler_factors(63, 70)
    got = dft.range_dft_channels(
        _complex(re, im), UNION, dft.to_matrix(dft.range_doppler_factors(63, 70)[0]),
        num_rx=4, cfgs_per_loop=3).numpy()
    assert got.shape == (3, len(UNION), 63, 70)
    for f in range(3):
        want = mxu.range_dft_channels(mxu.C2(re[f], im[f]), UNION, rng_f,
                                      num_rx=4, cfgs_per_loop=3)
        _assert_close_rel(got[f], mxu.to_complex(want))
        # and the unfused form: reformat, pick the channels, range DFT
        virt = jreformat(jnp.asarray(re[f] + 1j * im[f]), num_rx=4,
                         cfgs_per_loop=3)[np.asarray(UNION)]
        unfused = mxu.dft_apply(mxu.from_complex(virt), rng_f, axis=-2)
        _assert_close_rel(got[f], mxu.to_complex(unfused))
    # the port's own unfused form: its reformat, the channels, one matmul
    virt_t = reformat(_complex(re, im), num_rx=4, cfgs_per_loop=3)[:, list(UNION)]
    rng_t = dft.to_matrix(dft.range_doppler_factors(63, 70)[0])
    _assert_close_rel(got, torch.matmul(rng_t.T, virt_t).numpy())


def _jax_range_dft(re, im):
    rng_f, _ = mxu.range_doppler_factors(63, 70)
    return [mxu.range_dft_channels(mxu.C2(re[f], im[f]), UNION, rng_f,
                                   num_rx=4, cfgs_per_loop=3)
            for f in range(re.shape[0])]


def test_rd_values_matches_jax_exact_mode():
    re, im = _raw(2, seed=2)
    R = _jax_range_dft(re, im)
    _, dop_j = mxu.range_doppler_factors(63, 70)
    dop_t = dft.to_matrix(dft.range_doppler_factors(63, 70)[1])
    rng = np.random.default_rng(3)
    r_idx = rng.integers(0, 63, (2, 128))
    v_idx = rng.integers(0, 70, (2, 128))
    got = dft.rd_values(
        torch.stack([_complex(c.re, c.im) for c in R]), dop_t,
        torch.from_numpy(r_idx), torch.from_numpy(v_idx)).numpy()
    assert got.shape == (2, len(UNION), 128)
    for f in range(2):
        want = mxu.rd_values_from_range_dft(
            R[f], dop_j, jnp.asarray(r_idx[f]), jnp.asarray(v_idx[f]),
            mode="exact")
        _assert_close_rel(got[f], mxu.to_complex(want))


@pytest.mark.parametrize("subset", ["az", "el"])
def test_aoa_peak_angles_agree_with_jax(subset):
    """Given JAX's values, >= 99% of argmax picks agree (near-ties may flip)."""
    az_pos, el_pos = mxu.aoa_union_layout((0, 3, 4, 7), (9, 8, 5, 4))[1:3]
    pos = az_pos if subset == "az" else el_pos
    shift = subset == "az"
    angle_bins = grids.angle_bins(64).astype(np.float32)
    re, im = _raw(4, seed=4)
    R = _jax_range_dft(re, im)
    _, dop_j = mxu.range_doppler_factors(63, 70)
    rng = np.random.default_rng(5)
    picks_t, picks_j = [], []
    for f in range(4):
        r_idx = jnp.asarray(rng.integers(8, 55, 128))
        v_idx = jnp.asarray(rng.integers(7, 63, 128))
        vals = mxu.rd_values_from_range_dft(R[f], dop_j, r_idx, v_idx,
                                            mode="exact")
        picks_j.append(np.asarray(mxu.aoa_peak_angles(
            vals, pos, mxu.aoa_factors(4, 64, shift), jnp.asarray(angle_bins),
            precision="highest")))
        picks_t.append(dft.aoa_peak_angles(
            _complex(vals.re, vals.im)[None], torch.from_numpy(pos),
            dft.to_matrix(dft.aoa_factors(4, 64, shift)),
            torch.from_numpy(angle_bins))[0].numpy())
    agree = np.mean(np.concatenate(picks_t) == np.concatenate(picks_j))
    assert agree >= 0.99, agree


def test_aoa_peak_angles_ties_take_first_bin():
    """An all-zero snapshot has a flat spectrum: argmax must be bin 0."""
    bins = torch.arange(64, dtype=torch.float32)
    got = dft.aoa_peak_angles(torch.zeros(1, 4, 3, dtype=torch.complex64),
                              torch.arange(4),
                              dft.to_matrix(dft.aoa_factors(4, 64, True)), bins)
    assert torch.equal(got, torch.zeros(1, 3))


def test_cabs_matches_jax_to_one_ulp():
    """``sqrt(re*re + im*im)``: the squares and the sum are exact matches; the
    CPU build of PyTorch takes ``sqrt`` from a vector math library that is not
    always correctly rounded, so allow 1 ulp (CUDA's ``sqrtf`` is IEEE)."""
    rng = np.random.default_rng(6)
    re, im = (rng.standard_normal((2, 63, 70)).astype(np.float32) for _ in "ri")
    got = dft.cabs(_complex(re, im)).numpy()
    np.testing.assert_array_max_ulp(got, np.asarray(mxu.cabs(mxu.C2(re, im))),
                                    maxulp=1)
    # the formula, not torch.abs (hypot), which rounds differently
    z = _complex(re, im)
    np.testing.assert_array_equal(
        got, torch.sqrt(z.real * z.real + z.imag * z.imag).numpy())


def test_spherical_to_cartesian_matches_jax():
    rng = np.random.default_rng(7)
    r, az, el, v = (rng.uniform(-1.5, 1.5, 128).astype(np.float32) for _ in range(4))
    got = spherical_to_cartesian_flu(*(torch.from_numpy(a) for a in (r, az, el, v)))
    want = jpoint_cloud.spherical_to_cartesian_flu(r, az, el, v)
    # cos/sin of two libraries may differ by an ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------- #
# CFAR: bit-exact against both JAX forms, ties included
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("method", ["xla", "pallas"])
@pytest.mark.parametrize("params", [FLAGSHIP, SECOND], ids=["flagship", "second"])
def test_os_2d_detect_bit_exact_vs_jax(params, method):
    x = _quantized_maps((5, 63, 70), seed=2)
    want = np.asarray(jcfar.os_2d_detect(jnp.asarray(x), **params, method=method))
    got = cfar.os_2d_detect(torch.from_numpy(x), **params)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_os_2d_detect_leading_dims_and_small_maps():
    x = _quantized_maps((2, 3, 63, 70), seed=3)
    want = np.asarray(jcfar.os_2d_detect(jnp.asarray(x), **FLAGSHIP, method="xla"))
    np.testing.assert_array_equal(
        cfar.os_2d_detect(torch.from_numpy(x), **FLAGSHIP).numpy(), want)
    small = _quantized_maps((2, 10, 12), seed=4)  # smaller than one window
    got = cfar.os_2d_detect(torch.from_numpy(small), **FLAGSHIP)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcfar.os_2d_detect(jnp.asarray(small), **FLAGSHIP)))
    assert not got.any()


def test_os_rank_and_train_mask_equal_jax():
    for p in (FLAGSHIP, SECOND):
        mask = cfar.train_mask_2d(p["num_train"], p["num_guard"])
        np.testing.assert_array_equal(
            mask, jcfar._train_mask_2d(p["num_train"], p["num_guard"]))
        n = int(mask.sum())
        assert cfar.os_rank(p["rho"], n) == jcfar.os_rank(p["rho"], n)
    assert cfar.os_rank(0.7, 220) == 154


# --------------------------------------------------------------------------- #
# compaction
# --------------------------------------------------------------------------- #
def _mask_with(n_true, shape, seed, interior=(0, 0)):
    """Masks with exactly ``n_true`` True cells, all inside ``interior``."""
    rng = np.random.default_rng(seed)
    er, ed = interior
    inner = np.zeros((shape[0], shape[1] - 2 * er, shape[2] - 2 * ed), bool)
    for f in range(shape[0]):
        flat = inner[f].reshape(-1)
        flat[rng.choice(flat.size, n_true, replace=False)] = True
    mask = np.zeros(shape, bool)
    mask[:, er:shape[1] - er, ed:shape[2] - ed] = inner
    return mask


@pytest.mark.parametrize("n_true", [40, 128, 300], ids=["below", "equal", "above"])
@pytest.mark.parametrize("interior", [None, (8, 7)], ids=["full", "interior"])
def test_mask_to_indices_2d_bit_exact(n_true, interior):
    mask = _mask_with(n_true, (3, 63, 70), seed=n_true, interior=(8, 7))
    want = jax.vmap(lambda m: jmasked.mask_to_indices_2d(
        m, 128, interior=interior))(jnp.asarray(mask))
    got = masked.mask_to_indices_2d(torch.from_numpy(mask), 128, interior=interior)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].dtype == torch.int32
    assert got[3].tolist() == [min(n_true, 128)] * 3


@pytest.mark.parametrize("n, n_true", [(200, 10), (200, 32), (200, 90), (20, 7)],
                         ids=["below", "equal", "above", "capacity_over_length"])
def test_mask_to_indices_bit_exact(n, n_true):
    mask = _mask_with(n_true, (4, 1, n), seed=n + n_true)[:, 0]
    want = jax.vmap(lambda m: jmasked.mask_to_indices(m, 32))(jnp.asarray(mask))
    got = masked.mask_to_indices(torch.from_numpy(mask), 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------- #
# the kernel wrapper
# --------------------------------------------------------------------------- #
def test_launch_counter_stays_zero_on_cpu():
    kernel.os_cfar_2d_detect.launches = 0
    x = torch.from_numpy(_quantized_maps((2, 63, 70), seed=5))
    cfar.os_2d_detect(x, **FLAGSHIP)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernel.os_cfar_2d_detect(x, num_train=(5, 5), num_guard=(3, 2), k=154,
                                 alpha=4.0)
    assert kernel.os_cfar_2d_detect.launches == 0


@pytest.mark.parametrize("case", ["float64", "rank2", "strided", "meta", "alpha",
                                  "cpu"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The dispatch (``cfar.os_2d_detect``) and the launch both raise, never fall back."""
    x = torch.from_numpy(_quantized_maps((2, 63, 70), seed=6))
    launch = dict(num_train=(5, 5), num_guard=(3, 2), k=154, alpha=4.0)
    if case == "float64":
        with pytest.raises(TypeError, match="float32"):
            cfar.os_2d_detect(x.double(), **FLAGSHIP)
        with pytest.raises(TypeError, match="float32"):
            kernel.os_cfar_2d_detect(x.double(), **launch)
    elif case == "rank2":
        with pytest.raises(ValueError, match=r"\[B, R, D\]"):
            kernel.os_cfar_2d_detect(x[0], **launch)
    elif case == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            kernel.os_cfar_2d_detect(x.transpose(1, 2), **launch)
    elif case == "meta":  # neither CPU nor CUDA: no silent fallback
        with pytest.raises(ValueError, match="no OS-CFAR kernel for device"):
            cfar.os_2d_detect(x.to("meta"), **FLAGSHIP)
    elif case == "alpha":
        with pytest.raises(ValueError, match="alpha > 0"):
            cfar.os_2d_detect(x, **dict(FLAGSHIP, alpha=0.0))
    else:  # the launch never runs the plain version in the kernel's place
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            kernel.os_cfar_2d_detect(x, **launch)


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_is_keyed_on_its_source():
    lib = _build.library_path("os_cfar_detect")
    assert lib.parent == _build.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "torch_kernels")
    assert lib.name.startswith("os_cfar_detect-") and lib.suffix == ".so"
    assert (_build.CSRC_DIR / "os_cfar_detect.cu").is_file()
