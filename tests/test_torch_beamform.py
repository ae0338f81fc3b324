"""Parity of the port's beamforming ops and processors with the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
port.  The JAX side runs as its own tests run it on the CPU: the XLA forms
(Capon ``"linv"`` through the real 2A x 2A embedding, Bartlett
``bartlett_from_snapshots``) and the Pallas kernels in interpret mode
(``tests/test_beamform.py:175,360,400``).  Bars, from the JAX package's own:

- steering matrices: bit-equal (both build float64 numpy, cast once);
- the plain versions of the kernels against JAX's oracle and interpret-mode
  kernels: rtol 5e-5 (``tests/test_beamform.py:380,426``); Bartlett, whose
  covariance form cancels at deep nulls, also gets atol 1e-4 * max;
- the processors against JAX's: rtol 1e-4, atol 1e-4 * max (``:319-320``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmwave_radar_processing_tpu.config import grids
from mmwave_radar_processing_tpu.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_tpu.data.simulator import ods_geometry
from mmwave_radar_processing_tpu.ops import beamform as jbf
from mmwave_radar_processing_tpu.ops import mxu
from mmwave_radar_processing_tpu.ops.pallas import beamform as jpallas_beamform
from mmwave_radar_processing_tpu.ops.pallas import capon as jpallas_capon
from mmwave_radar_processing_tpu.processors import beamforming as jproc
from mmwave_radar_processing_tpu.processors.virtual_array import (
    VirtualArrayReformatter,
)
from mmwave_radar_processing_tpu_torch.ops import beamform as bf
from mmwave_radar_processing_tpu_torch.ops.kernels import beamform as kernel
from mmwave_radar_processing_tpu_torch.processors import beamforming as proc

torch.set_num_threads(2)  # tier-1 runs several xdist workers

KERNEL_RTOL = 5e-5
PROC_RTOL = 1e-4
PROCESSORS = [(jproc.BartlettBeamformerProcessor, proc.BartlettBeamformerProcessor),
              (jproc.CaponBeamformerProcessor, proc.CaponBeamformerProcessor)]
PROC_IDS = ["bartlett", "capon"]


def _snapshots(seed, shape):
    """Split float32 planes and the complex64 tensor of the same numbers."""
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    return re, im, torch.complex(torch.from_numpy(re), torch.from_numpy(im))


def _c2(re, im):
    return mxu.C2(jnp.asarray(re), jnp.asarray(im))


def _steering(n_ant, m):
    phase = grids.phase_shift_bins(m)
    return jbf.steering_ula(phase, n_ant), bf.steering_ula(phase, n_ant)


def _assert_close_to_max(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4 * np.abs(want).max())


def _as_split(t: torch.Tensor):
    return t.real.numpy(), t.imag.numpy()


# --------------------------------------------------------------------------- #
# steering matrices
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_ant,m", [(4, 64), (12, 64), (16, 48), (1, 7)])
def test_steering_ula_is_bit_equal(n_ant, m):
    want, got = _steering(n_ant, m)
    assert got.dtype == torch.complex64 and got.shape == (n_ant, m)
    re, im = _as_split(got)
    np.testing.assert_array_equal(re, np.asarray(want.re))
    np.testing.assert_array_equal(im, np.asarray(want.im))


@pytest.mark.parametrize("geometry", ["l_array", "full_aperture"])
def test_steering_planar_is_bit_equal(geometry):
    if geometry == "l_array":
        _, pos = jproc.l_array_positions(jproc.ODS_AZ_IDXS, jproc.ODS_EL_IDXS)
    else:
        ys, zs = ods_geometry().virtual_offsets(4, [0, 1, 2])
        pos = np.stack([ys, zs], axis=1)
    az, el = grids.angle_bins(64), grids.angle_bins(32)
    want = jbf.steering_planar(pos, az, el)
    got = bf.steering_planar(pos, az, el)
    assert got.shape == (len(pos), 64 * 32)
    re, im = _as_split(got)
    np.testing.assert_array_equal(re, np.asarray(want.re))
    np.testing.assert_array_equal(im, np.asarray(want.im))


# --------------------------------------------------------------------------- #
# covariance and the plain spectra
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_ant", [4, 12])
def test_spatial_covariance_matches_jax(n_ant):
    re, im, x = _snapshots(1, (5, n_ant, 70))
    want = jbf.spatial_covariance(_c2(re, im))
    got = bf.spatial_covariance(x)
    # float32 sums of 70 products in another order
    np.testing.assert_allclose(got.real.numpy(), np.asarray(want.re), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.imag.numpy(), np.asarray(want.im), rtol=1e-5, atol=1e-5)


def test_diagonal_load_matches_jax():
    re, im, x = _snapshots(2, (3, 6, 40))
    r_j = jbf.spatial_covariance(_c2(re, im))
    r_t = torch.complex(torch.from_numpy(np.array(r_j.re)),
                        torch.from_numpy(np.array(r_j.im)))
    want = jbf.diagonal_load(r_j, 1e-2)
    got = bf.diagonal_load(r_t, 1e-2)
    np.testing.assert_allclose(got.real.numpy(), np.asarray(want.re), rtol=1e-6)
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.im))


@pytest.mark.parametrize("n_ant", [4, 12, 16])
def test_bartlett_forms_match_jax_xla(n_ant):
    re, im, x = _snapshots(3, (7, n_ant, 70))
    st_j, st_t = _steering(n_ant, 64)
    want = np.asarray(jbf.bartlett_from_snapshots(_c2(re, im), st_j))
    _assert_close_to_max(bf.bartlett_from_snapshots(x, st_t).numpy(), want, KERNEL_RTOL)
    from_cov = bf.bartlett_from_covariance(bf.spatial_covariance(x), st_t).numpy()
    _assert_close_to_max(from_cov, want, KERNEL_RTOL)
    want_cov = np.asarray(jbf.bartlett_from_covariance(
        jbf.spatial_covariance(_c2(re, im)), st_j))
    _assert_close_to_max(from_cov, want_cov, KERNEL_RTOL)


@pytest.mark.parametrize("n_ant", [4, 12, 16])
def test_capon_matches_jax_linv(n_ant):
    re, im, x = _snapshots(4, (6, n_ant, 70))
    st_j, st_t = _steering(n_ant, 64)
    # JAX's "linv" runs the unrolled real embedding up to 2A = 24, and
    # jnp.linalg.cholesky above it (A = 16)
    want = np.asarray(jbf.capon_from_covariance(
        jbf.spatial_covariance(_c2(re, im)), st_j, loading=1e-2, method="linv"))
    got = bf.capon_from_covariance(bf.spatial_covariance(x), st_t, loading=1e-2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_RTOL)


def test_capon_matches_float64_oracle():
    re, im, x = _snapshots(5, (4, 8, 40))
    _, st = _steering(8, 48)
    xc = (re + 1j * im).astype(np.complex128)
    r = xc @ xc.conj().swapaxes(-1, -2) / xc.shape[-1]
    tr = np.trace(r, axis1=-2, axis2=-1).real[..., None, None]
    r = r + (1e-2 * tr / 8 + 1e-12) * np.eye(8)
    a = st.numpy().astype(np.complex128)
    y = np.linalg.solve(r, np.broadcast_to(a, r.shape[:-2] + a.shape))
    oracle = 1.0 / np.real(np.einsum("am,...am->...m", a.conj(), y))
    got = bf.capon_from_covariance(bf.spatial_covariance(x), st, loading=1e-2)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4)


def test_cholesky_guard_keeps_a_singular_matrix_finite():
    # rank 1 and unloaded: the second pivot rounds to <= 0, where
    # torch.linalg.cholesky would raise; the guard takes sqrt(tiny)
    v = torch.tensor([1.0 + 0.5j, 2.0 - 1.0j, -0.5 + 0.25j], dtype=torch.complex64)
    r = torch.outer(v, v.conj())
    lower = bf.cholesky_lower(r)
    assert bool(torch.isfinite(torch.view_as_real(lower)).all())
    np.testing.assert_allclose(torch.matmul(lower, lower.mH)[:, 0].numpy(),
                               r[:, 0].numpy(), rtol=1e-6)
    _, st = _steering(3, 16)
    p = bf.capon_from_covariance(r, st, loading=0.0)
    assert bool(torch.isfinite(p).all()) and bool((p >= 0).all())


# --------------------------------------------------------------------------- #
# the dispatch functions (the kernels' plain versions) against the TPU kernels
# --------------------------------------------------------------------------- #
# interpret mode traces the Pallas body unrolled over antennas and frames (at
# A = 16 about a minute for one frame), so these run one frame of 3 range bins
@pytest.mark.parametrize("n_ant", [4, 12, 16])
def test_capon_power_matches_interpret_kernel_and_linv(n_ant):
    re, im, x = _snapshots(6, (1, n_ant, 3, 70))
    st_j, st_t = _steering(n_ant, 64)
    got = bf.capon_power(x, st_t, loading=1e-2)
    assert got.shape == (1, 3, 64) and got.dtype == torch.float32
    pallas = np.asarray(jpallas_capon.capon_power_pallas(
        re, im, np.asarray(st_j.re), np.asarray(st_j.im), loading=1e-2,
        interpret=True, frames_per_block=1))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=KERNEL_RTOL)
    snaps = _c2(np.moveaxis(re, 1, 2), np.moveaxis(im, 1, 2))
    linv = np.asarray(jbf.capon_from_covariance(
        jbf.spatial_covariance(snaps), st_j, loading=1e-2, method="linv"))
    np.testing.assert_allclose(got.numpy(), linv, rtol=KERNEL_RTOL)


@pytest.mark.parametrize("n_ant", [4, 12, 16])
def test_bartlett_power_matches_interpret_kernels_and_xla(n_ant):
    re, im, x = _snapshots(7, (1, n_ant, 9, 70))
    st_j, st_t = _steering(n_ant, 64)
    got = bf.bartlett_power(x, st_t).numpy()
    assert got.shape == (1, 9, 64)
    cov_kernel = np.asarray(jpallas_capon.bartlett_power_pallas_cov(
        re, im, np.asarray(st_j.re), np.asarray(st_j.im), interpret=True,
        frames_per_block=1))
    _assert_close_to_max(got, cov_kernel, KERNEL_RTOL)
    snaps = _c2(np.moveaxis(re, 1, 2), np.moveaxis(im, 1, 2))
    snap_kernel = np.asarray(jpallas_beamform.bartlett_power(snaps, st_j,
                                                             interpret=True))
    _assert_close_to_max(got, snap_kernel, KERNEL_RTOL)
    _assert_close_to_max(got, np.asarray(jbf.bartlett_from_snapshots(snaps, st_j)),
                         KERNEL_RTOL)


def test_snapshot_blocks_are_a_one_bin_layout():
    # TPU kernel #9's [N, A, K] blocks are [N, A, 1, K] for the port's kernel
    re, im, x = _snapshots(8, (13, 12, 70))
    st_j, st_t = _steering(12, 64)
    got = bf.bartlett_power(x[:, :, None, :], st_t)[:, 0].numpy()
    want = np.asarray(jpallas_beamform.bartlett_power(_c2(re, im), st_j,
                                                      interpret=True))
    _assert_close_to_max(got, want, KERNEL_RTOL)


@pytest.mark.parametrize("case", ["dtype", "shape", "antennas", "device"])
@pytest.mark.parametrize("fn", ["capon", "bartlett"])
def test_dispatch_rejects_what_it_does_not_take(case, fn):
    x = torch.zeros(1, 4, 3, 8, dtype=torch.complex64)
    st = torch.zeros(4, 5, dtype=torch.complex64)
    error = ValueError
    if case == "dtype":
        x, error = x.to(torch.complex128), TypeError
    elif case == "shape":
        x = x[0]
    elif case == "antennas":
        st = st[:3]
    else:  # no device other than the CPU and CUDA: no silent plain version
        x, st = x.to("meta"), st.to("meta")
    call = (lambda: bf.capon_power(x, st, loading=1e-2)) if fn == "capon" \
        else (lambda: bf.bartlett_power(x, st))
    with pytest.raises(error):
        call()


@pytest.mark.parametrize("fn", [kernel.capon_power, kernel.bartlett_power],
                         ids=["capon", "bartlett"])
def test_kernel_wrapper_raises_on_cpu_tensors(fn):
    x = torch.zeros(1, 4, 3, 8, dtype=torch.complex64)
    st = torch.zeros(4, 5, dtype=torch.complex64)
    before = fn.launches
    with pytest.raises(ValueError, match="need CUDA tensors"):
        fn(x, st, loading=1e-2) if fn is kernel.capon_power else fn(x, st)
    assert fn.launches == before


# --------------------------------------------------------------------------- #
# processors
# --------------------------------------------------------------------------- #
def _virtual_frame(cfg, seed, targets):
    raw = simulate_frame(cfg, Scene(targets=targets, noise_sigma=0.05),
                         np.random.default_rng(seed))
    return np.asarray(VirtualArrayReformatter(cfg).process(raw)).astype(np.complex64)


@pytest.fixture(scope="module")
def virt(flagship_config):
    return _virtual_frame(flagship_config, 3, [
        PointTarget(range_m=1.5, azimuth_rad=0.25, velocity_m_s=0.3, rcs=4.0),
        PointTarget(range_m=2.2, azimuth_rad=-0.4, elevation_rad=0.2,
                    velocity_m_s=-0.5, rcs=3.0)])


def test_l_array_positions_equal_jax():
    for az, el in ((jproc.ODS_AZ_IDXS, jproc.ODS_EL_IDXS), ((0, 1, 2), (5, 6)),
                   ((1, 2, 3), (7, 2, 9))):
        want_idx, want_pos = jproc.l_array_positions(az, el)
        got_idx, got_pos = proc.l_array_positions(az, el)
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_array_equal(got_pos, want_pos)
        assert got_pos.dtype == np.float32
    assert proc.ODS_AZ_IDXS == jproc.ODS_AZ_IDXS
    assert proc.ODS_EL_IDXS == jproc.ODS_EL_IDXS


@pytest.mark.parametrize("classes", PROCESSORS, ids=PROC_IDS)
@pytest.mark.parametrize("antennas", ["ods_az", "all_virtual"])
def test_processor_heatmap_matches_jax(flagship_config, virt, classes, antennas):
    jcls, tcls = classes
    idxs = jproc.ODS_AZ_IDXS if antennas == "ods_az" else None
    want_proc = jcls(flagship_config, antenna_idxs=idxs, diagonal_loading=1e-2)
    got_proc = tcls(flagship_config, antenna_idxs=idxs, diagonal_loading=1e-2,
                    device="cpu")
    np.testing.assert_array_equal(got_proc.antenna_idxs, want_proc.antenna_idxs)
    assert len(got_proc.antenna_idxs) == (4 if idxs else 12)
    want = np.asarray(want_proc.process(virt))
    got = got_proc.process(virt)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape == (63, 64)
    _assert_close_to_max(got.numpy(), want, PROC_RTOL)
    for name in ("range_bins", "phase_shifts", "angle_bins", "x_s", "y_s"):
        np.testing.assert_array_equal(getattr(got_proc, name), getattr(want_proc, name))


@pytest.mark.parametrize("classes", PROCESSORS, ids=PROC_IDS)
@pytest.mark.parametrize("geometry", ["l_array", "full_aperture"])
def test_azimuth_elevation_heatmap_matches_jax(flagship_config, virt, classes,
                                               geometry):
    jcls, tcls = classes
    kw = {}
    if geometry == "full_aperture":
        ys, zs = ods_geometry().virtual_offsets(4, [0, 1, 2])
        kw = dict(positions=np.stack([ys, zs], axis=1))
    r_i = int(np.argmin(np.abs(grids.range_bins(flagship_config, variant="eps") - 2.2)))
    want = jcls(flagship_config).azimuth_elevation_heatmap(virt, r_i, **kw)
    got = tcls(flagship_config, device="cpu").azimuth_elevation_heatmap(virt, r_i, **kw)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (64, 32)
    _assert_close_to_max(got, want, PROC_RTOL)


def test_snapshots_match_jax(flagship_config, virt):
    want = jproc.CaponBeamformerProcessor(
        flagship_config, antenna_idxs=jproc.ODS_AZ_IDXS).snapshots(mxu.from_complex(virt))
    got = proc.CaponBeamformerProcessor(
        flagship_config, antenna_idxs=jproc.ODS_AZ_IDXS, device="cpu").snapshots(virt)
    assert got.shape == (63, 4, 70) and got.dtype == torch.complex64
    # windowed DFT of 63 samples: float32 matmuls in another order
    for g, w in ((got.real, want.re), (got.imag, want.im)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5 * float(np.abs(np.asarray(w)).max()))


def test_process_takes_numpy_and_tensors(flagship_config, virt):
    p = proc.BartlettBeamformerProcessor(flagship_config, antenna_idxs=jproc.ODS_AZ_IDXS,
                                         device="cpu")
    from_numpy = p.process(virt)
    from_tensor = p.process(torch.from_numpy(virt))
    from_c128 = p.process(torch.from_numpy(virt.astype(np.complex128)))
    assert torch.equal(from_numpy, from_tensor) and torch.equal(from_numpy, from_c128)
    assert torch.equal(p.heatmap(virt), from_numpy)


def test_processor_requires_a_device(flagship_config):
    with pytest.raises(TypeError):
        proc.CaponBeamformerProcessor(flagship_config)
    with pytest.raises(ValueError, match="unsupported device"):
        proc.CaponBeamformerProcessor(flagship_config, device="meta")


def test_processor_keeps_history(flagship_config):
    p = proc.CaponBeamformerProcessor(flagship_config, device="cpu")
    p.update_history(estimated=[1.0, 2.0], ground_truth=[1.5, 2.5])
    assert len(p.history_estimated) == len(p.history_gt) == 1
    p.reset()
    assert p.history_estimated == [] and p.history_gt == []


# --------------------------------------------------------------------------- #
# planted-target physics
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cls", [proc.BartlettBeamformerProcessor,
                                 proc.CaponBeamformerProcessor], ids=PROC_IDS)
def test_heatmap_peaks_on_planted_target(flagship_config, cls):
    virt = _virtual_frame(flagship_config, 3, [
        PointTarget(range_m=1.5, azimuth_rad=0.25, velocity_m_s=0.0, rcs=4.0)])
    p = cls(flagship_config, antenna_idxs=proc.ODS_AZ_IDXS, device="cpu")
    heat = p.process(virt).numpy()
    r_i, a_i = np.unravel_index(np.argmax(heat), heat.shape)
    assert abs(p.range_bins[r_i] - 1.5) < 2 * flagship_config.range_res_m
    assert abs(p.angle_bins[a_i] - 0.25) < 2 * np.pi / 63


def test_capon_resolves_what_bartlett_cannot(flagship_config):
    az1, az2 = -0.15, 0.15
    raw = simulate_frame(flagship_config, Scene(targets=[
        PointTarget(range_m=1.5, azimuth_rad=az1, rcs=4.0, velocity_m_s=0.35),
        PointTarget(range_m=1.5, azimuth_rad=az2, rcs=4.0, velocity_m_s=-0.45,
                    phase_rad=1.3)], noise_sigma=0.02), np.random.default_rng(5))
    virt = VirtualArrayReformatter(flagship_config).process(raw)
    bart = proc.BartlettBeamformerProcessor(flagship_config,
                                            antenna_idxs=proc.ODS_AZ_IDXS, device="cpu")
    capon = proc.CaponBeamformerProcessor(flagship_config, antenna_idxs=proc.ODS_AZ_IDXS,
                                          diagonal_loading=1e-3, device="cpu")
    r_i = int(np.argmin(np.abs(bart.range_bins - 1.5)))
    angles = bart.angle_bins
    i1, i2 = (int(np.argmin(np.abs(angles - a))) for a in (az1, az2))
    mid = int(np.argmin(np.abs(angles)))

    def depth(row):
        return max(row[min(i1, i2)], row[max(i1, i2)]) / row[mid]

    capon_depth = depth(capon.process(virt).numpy()[r_i])
    assert capon_depth > 1.5
    assert capon_depth > 2 * depth(bart.process(virt).numpy()[r_i])


@pytest.mark.parametrize("cls", [proc.BartlettBeamformerProcessor,
                                 proc.CaponBeamformerProcessor], ids=PROC_IDS)
def test_azimuth_elevation_heatmap_peaks_on_target(flagship_config, cls):
    az_t, el_t = 0.3, -0.2
    virt = _virtual_frame(flagship_config, 7, [
        PointTarget(range_m=1.5, azimuth_rad=az_t, elevation_rad=el_t, rcs=4.0)])
    ys, zs = ods_geometry().virtual_offsets(4, [0, 1, 2])
    p = cls(flagship_config, device="cpu")
    r_i = int(np.argmin(np.abs(p.range_bins - 1.5)))
    heat = p.azimuth_elevation_heatmap(virt, r_i, positions=np.stack([ys, zs], axis=1))
    a_i, e_i = np.unravel_index(np.argmax(heat), heat.shape)
    assert abs(grids.angle_bins(64)[a_i] - az_t) < 2 * np.pi / 63
    assert abs(grids.angle_bins(32)[e_i] - el_t) < 2 * np.pi / 31
