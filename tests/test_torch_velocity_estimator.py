"""The port's velocity object API against the JAX package on the CPU.

- dense ``prominences``, ``find_peaks``, ``best_peak`` and ``top_k_masked``:
  equal to the JAX functions (comparisons and selections only), ties included
  (but for the order among equal values where ``lax.top_k`` takes every entry);
- ``DopplerAzimuthProcessor``: coarse and precise responses within rtol 1e-4
  and atol 1e-4 of the map's maximum (FFTs in another order); the peak
  detectors' outputs equal.  A zoom band that holds no return is held to a
  float64 evaluation instead (see that test);
- ``processors.VelocityEstimator`` (ODS and standard geometry, coarse and
  precise, ``hybrid_points`` and ``x_measurement_only``) with the JAX key
  stream's Gumbel draws handed in: velocity within 1e-4;
- the points ``VelocityEstimator`` and ``VehicleVelEstimator``, with JAX's
  draws: within 1e-4;
- the goldens ``velocity_adc_ods`` and ``velocity_points`` under each
  scenario's own ``compare``, with the port's own draws.

The frames are ground scenes of the golden scenarios' kind (``ground_scene``
at 1.2 m, 200 patches, noise 0.01).
"""

import os

import jax
import numpy as np
import pytest
import torch

from golden_scenarios import GOLDEN_DIR, SCENARIOS, STANDARD_CFG, VEL_ALTITUDE
from mmwave_radar_processing_tpu.config import load_cfg as jax_load_cfg
from mmwave_radar_processing_tpu.ops import masked as jmasked, peaks as jpeaks
from mmwave_radar_processing_tpu.point_cloud_processing import (
    VehicleVelEstimator as JaxVehicle,
    VelocityEstimator as JaxPointsVE,
)
from mmwave_radar_processing_tpu.processors.doppler_azimuth import (
    DopplerAzimuthProcessor as JaxDAP,
)
from mmwave_radar_processing_tpu.processors.velocity_estimator import (
    VelocityEstimator as JaxVE,
)
from mmwave_radar_processing_tpu_torch import load_cfg
from mmwave_radar_processing_tpu_torch.data import ground_scene, simulate_frame
from mmwave_radar_processing_tpu_torch.ops import masked, peaks
from mmwave_radar_processing_tpu_torch.point_cloud_processing import (
    VehicleVelEstimator,
    VelocityEstimator as PointsVE,
)
from mmwave_radar_processing_tpu_torch.processors import (
    DopplerAzimuthProcessor,
    VelocityEstimator,
    VirtualArrayReformatter,
)

torch.set_num_threads(2)

VELOCITY_ATOL = 1e-4
RESP_RTOL, RESP_ATOL_OF_MAX = 1e-4, 1e-4
EGOS = ((1.2, 0.3, -0.1), (0.05, 0.5, 0.2), (0.8, -0.4, 0.0))
VE_KW = dict(lower_range_bound=0.5, upper_range_bound=0.5, min_R2_threshold=0.2,
             min_inlier_percent=0.3)


def _jax_draws(key, trials, n):
    """``ransac_linear``'s draws from one key: ``split(key, trials)``, then ``gumbel(k, (n,))``."""
    return np.stack([np.asarray(jax.random.gumbel(k, (n,)))
                     for k in jax.random.split(key, trials)]).astype(np.float32)


class JaxKeyStream:
    """The JAX estimators' ``_next_key`` stream, as draws: one fit per call."""

    def __init__(self, seed, trials=20):
        self.key, self.trials = jax.random.PRNGKey(seed), trials

    def __call__(self, n, trials=None):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(_jax_draws(sub, trials or self.trials, n))


@pytest.fixture(scope="module")
def geometries(flagship_cfg_path):
    paths = {"ods": flagship_cfg_path, "standard": STANDARD_CFG}
    return {g: (load_cfg(p, array_geometry=g, array_direction="down"),
                jax_load_cfg(p, array_geometry=g, array_direction="down"))
            for g, p in paths.items()}


@pytest.fixture(scope="module")
def frames(geometries):
    """Per geometry: virtual cubes (complex128 numpy) of three ground scenes."""
    out = {}
    for geometry, (cfg, _) in geometries.items():
        rng = np.random.default_rng(17)
        var = VirtualArrayReformatter(cfg, device="cpu")
        cubes = []
        for ego in EGOS:
            scene = ground_scene(cfg, altitude_m=1.2, ego_vel=np.asarray(ego),
                                 num_patches=200, rng=rng, noise_sigma=0.01)
            cubes.append(var.process(simulate_frame(cfg, scene, rng)).numpy()
                         .astype(np.complex128))
        out[geometry] = cubes
    return out


# --------------------------------------------------------------------------- #
# small ops
# --------------------------------------------------------------------------- #
def _rows(seed, n_rows=24, n=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (n_rows, n)).astype(np.float32)
    x[:8] = np.round(x[:8])  # plateaus and equal peaks
    x[8, :] = 1.0  # flat: no peak
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_prominences_equal_jax(seed):
    x = _rows(seed)
    mask = np.asarray(jax.vmap(jpeaks.local_maxima)(x))
    want = jax.vmap(jpeaks.prominences)(x, mask)
    got = peaks.prominences(torch.from_numpy(x), torch.from_numpy(mask.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() > 0).sum() > 20


@pytest.mark.parametrize("min_prominence", [None, 0.0, 3.0, 8.0])
def test_find_peaks_equals_jax(min_prominence):
    x = _rows(2)
    want = jax.vmap(lambda r: jpeaks.find_peaks(r, 12, min_prominence))(x)
    got = peaks.find_peaks(torch.from_numpy(x), 12, min_prominence)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_best_peak_equals_jax():
    x = _rows(3)
    want = jax.vmap(jpeaks.best_peak)(x)
    got = peaks.best_peak(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not bool(got[2][8])  # the flat row


@pytest.mark.parametrize("k", [1, 5, 40])
@pytest.mark.parametrize("ties", [False, True])
def test_top_k_masked_equals_jax(k, ties):
    """Equal to ``lax.top_k``'s selection.  Among equal values the JAX order is
    ascending index for ``k < n`` but not for ``k == n`` on the CPU; there the
    indices of each run of equal values are compared as sets."""
    x = _rows(4)
    if not ties:
        x = x + np.arange(x.size, dtype=np.float32).reshape(x.shape) * 1e-3
    valid = np.random.default_rng(5).random(x.shape) < 0.6
    want = [np.asarray(a) for a in
            jax.vmap(lambda v, m: jmasked.top_k_masked(v, m, k))(x, valid)]
    got = [a.numpy() for a in masked.top_k_masked(torch.from_numpy(x),
                                                  torch.from_numpy(valid), k)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    if k < x.shape[1] or not ties:
        np.testing.assert_array_equal(got[1], want[1])
    for row in range(x.shape[0]):
        for value in np.unique(got[0][row]):
            run = got[0][row] == value
            assert set(got[1][row][run]) == set(want[1][row][run])
            assert (np.diff(got[1][row][run]) > 0).all()  # ascending in the port


# --------------------------------------------------------------------------- #
# Doppler-azimuth processor
# --------------------------------------------------------------------------- #
def _assert_maps_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RESP_RTOL,
                               atol=RESP_ATOL_OF_MAX * float(np.abs(want).max()))


def _precise_float64(proc, cube, rx, range_window, bins, row_valid):
    """The precise response in float64 numpy: an explicit zoom DTFT of each half-band."""
    rng_fft = proc._prepare(cube, rx).numpy().astype(np.complex128)
    data = np.moveaxis(rng_fft, -3, -1)
    data = np.pad(data, [(0, 0), (0, 0), (0, proc.num_angle_bins - data.shape[-1])])
    nv, vmax = proc.num_vel_bins, proc.config.vel_max_m_s
    bins = bins.numpy().astype(np.float64)
    halves = []
    for half, shift in ((bins[:nv], 2 * vmax), (bins[nv:], 0.0)):
        f1, f2 = ((half.min() + shift) * proc._vel_scale,
                  (half.max() + shift) * proc._vel_scale)
        freqs = f1 + np.arange(nv) * (f2 - f1) / nv
        dtft = np.exp(-2j * np.pi * np.outer(np.arange(nv), freqs) / (2 * proc._vel_fs))
        zoomed = np.einsum("rca,ck->rka", data[:, :nv], dtft)
        halves.append(np.abs(np.fft.fft(zoomed, axis=2)))
    resp = np.fft.fftshift(np.concatenate(halves, axis=1), axes=2)
    resp = resp * row_valid.numpy()[None, :, None]
    resp = resp[..., proc.valid_angle_mask]
    rmask = (proc.range_bins.astype(np.float32) >= np.float32(range_window[0])) & (
        proc.range_bins.astype(np.float32) <= np.float32(range_window[1]))
    return (resp * rmask[:, None, None]).sum(axis=0) / max(rmask.sum(), 1)


@pytest.mark.parametrize("precise", [False, True], ids=["coarse", "precise"])
@pytest.mark.parametrize("geometry", ["ods", "standard"])
def test_doppler_azimuth_processor_matches_jax(geometries, frames, geometry, precise):
    """Responses at rtol 1e-4, atol 1e-4 of the maximum; row and zero-azimuth peaks equal.

    The precise band is the estimator's: +-0.25 m/s around the frame's
    ``-vx``.
    """
    cfg, jcfg = geometries[geometry]
    port, ref = DopplerAzimuthProcessor(cfg, device="cpu"), JaxDAP(jcfg)
    rx = [0, 3, 4, 7] if geometry == "ods" else None
    for cube, ego in zip(frames[geometry], EGOS):
        kw = dict(rx_antennas=rx, range_window=np.array([0.7, 1.7]),
                  use_precise_fft=precise,
                  precise_vel_range=(-ego[0] - 0.25, -ego[0] + 0.25))
        got, want = port.process(cube, **kw), ref.process(cube, **kw)
        if precise:
            (got, got_bins, got_valid), (want, want_bins, want_valid) = got, want
            np.testing.assert_array_equal(got_bins.numpy(), np.asarray(want_bins))
            np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
            bins, row_valid = got_bins, got_valid
            jbins, jrow_valid = want_bins, want_valid
        else:
            bins = jbins = port.vel_bins
            row_valid = jrow_valid = None
        _assert_maps_close(got, want)
        rows = port.detect_peaks_rows(got, bins, row_valid=row_valid)
        jrows = ref.detect_peaks_rows(want, jbins, row_valid=jrow_valid)
        for g, w in zip(rows, jrows):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(rows[2].sum()) > 5
        zero = port.detect_peak_zero_az(got, bins, row_valid=row_valid)
        jzero = ref.detect_peak_zero_az(want, jbins, row_valid=jrow_valid)
        for g, w in zip(zero, jzero):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("geometry", ["ods", "standard"])
def test_precise_response_of_an_empty_band_against_float64(geometries, frames, geometry):
    """A zoom band that holds no return: float32 cannot hold it to 1e-4 of its maximum.

    The second frame moves at vx = 0.05 m/s; the band -1.05..-0.55 m/s
    holds only the leakage of returns outside it, whose float32 rounding in
    the Bluestein chirp (phases of hundreds of radians) is of the band's own
    size: on the standard geometry both packages stray from a float64
    evaluation of the same response by some 7e-4 of its maximum.  The port
    is held to that evaluation: no further from it than twice the JAX
    package's distance, or 1e-4 of the maximum.
    """
    cfg, jcfg = geometries[geometry]
    port, ref = DopplerAzimuthProcessor(cfg, device="cpu"), JaxDAP(jcfg)
    rx = [0, 3, 4, 7] if geometry == "ods" else None
    window = np.array([0.7, 1.7])
    kw = dict(rx_antennas=rx, range_window=window, use_precise_fft=True,
              precise_vel_range=(-1.05, -0.55))
    cube = frames[geometry][1]
    got, bins, row_valid = port.process(cube, **kw)
    want = np.asarray(ref.process(cube, **kw)[0])
    exact = _precise_float64(port, cube, rx, window, bins, row_valid)
    top = float(np.abs(exact).max())
    port_err = float(np.abs(got.numpy() - exact).max())
    jax_err = float(np.abs(want - exact).max())
    assert port_err <= max(2 * jax_err, RESP_ATOL_OF_MAX * top), (port_err, jax_err, top)


def test_precise_grid_clamps_and_masks_an_empty_side(geometries, frames):
    """A band wholly above zero: the negative side is masked, the range clamped to vmax."""
    cfg, jcfg = geometries["ods"]
    port, ref = DopplerAzimuthProcessor(cfg, device="cpu"), JaxDAP(jcfg)
    for vel_range in ((0.2, 0.25), (-9.0, 9.0), (cfg.vel_max_m_s - 0.01, 9.0)):
        kw = dict(rx_antennas=[0, 3, 4, 7], use_precise_fft=True,
                  precise_vel_range=vel_range)
        (got, bins, valid), (want, wbins, wvalid) = (
            port.process(frames["ods"][0], **kw), ref.process(frames["ods"][0], **kw))
        np.testing.assert_array_equal(bins.numpy(), np.asarray(wbins))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
        _assert_maps_close(got, want)
    assert not bool(valid[: port.num_vel_bins].any()) or vel_range[0] < 0


# --------------------------------------------------------------------------- #
# ADC velocity estimator
# --------------------------------------------------------------------------- #
def _points_for(geometries, cube):
    """A padded standard-geometry point cloud of one frame (zero rows included)."""
    from mmwave_radar_processing_tpu_torch import PointCloudGenerator

    cfg = geometries["standard"][0]
    pcg = PointCloudGenerator(cfg, list(range(8)), [], device="cpu")
    pts = pcg.process(cube)
    return np.concatenate([pts, np.zeros((4, 4), np.float32)]).astype(np.float64)


CASES = {
    "ods_coarse": ("ods", False, {}),
    "ods_precise": ("ods", True, {}),
    "ods_x_only": ("ods", True, dict(x_measurement_only=True)),
    "standard_coarse": ("standard", False, {}),
    "standard_precise": ("standard", True, {}),
    "standard_hybrid_points": ("standard", False, dict(vy_mode="hybrid_points")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_velocity_estimator_matches_jax_with_its_draws(geometries, frames, case):
    geometry, precise, extra = CASES[case]
    cfg, jcfg = geometries[geometry]
    port = VelocityEstimator(cfg, device="cpu", **VE_KW, **extra)
    ref = JaxVE(jcfg, **VE_KW, **extra)
    port._draw_scores = JaxKeyStream(42)
    hybrid = extra.get("vy_mode") == "hybrid_points"
    moved = 0
    for cube in frames[geometry]:
        pts = _points_for(geometries, cube) if hybrid else None
        want = np.asarray(ref.process(adc_cube=cube, points=pts, altitude=1.2,
                                      enable_precise_responses=precise)).copy()
        got = np.asarray(port.process(adc_cube=cube, points=pts, altitude=1.2,
                                      enable_precise_responses=precise)).copy()
        np.testing.assert_allclose(got, want, rtol=0, atol=VELOCITY_ATOL)
        moved += int(np.count_nonzero(want))
        for name in ("azimuth_estimate_R2", "azimuth_inlier_percent",
                     "elevation_estimate_R2", "elevation_inlier_percent"):
            assert abs(getattr(port, name) - getattr(ref, name)) <= 1e-3, name
        if not extra.get("x_measurement_only"):
            np.testing.assert_array_equal(port.azimuth_peaks, ref.azimuth_peaks)
    assert moved >= len(frames[geometry])
    port.update_history([1.0, 0.0, 0.0])
    port.reset()
    assert port.history_R2_statistics == [] and port.history_estimated == []


def test_points_path_of_the_adc_estimator_matches_jax(geometries, frames):
    cfg, jcfg = geometries["standard"]
    port, ref = VelocityEstimator(cfg, device="cpu", **VE_KW), JaxVE(jcfg, **VE_KW)
    port._draw_scores = JaxKeyStream(42)
    pts = _points_for(geometries, frames["standard"][0])[:-4]
    want = np.asarray(ref.process(points=pts)).copy()
    got = np.asarray(port.process(points=pts)).copy()
    np.testing.assert_allclose(got, want, rtol=0, atol=VELOCITY_ATOL)
    assert port._points_path and np.count_nonzero(want) > 0


def test_hybrid_points_is_standard_geometry_only(geometries):
    with pytest.raises(ValueError, match="standard-geometry"):
        VelocityEstimator(geometries["ods"][0], device="cpu", vy_mode="hybrid_points",
                          **VE_KW)
    with pytest.raises(TypeError):
        VelocityEstimator(geometries["ods"][0], **VE_KW)  # no implicit device


# --------------------------------------------------------------------------- #
# points estimators
# --------------------------------------------------------------------------- #
def _ground_points(seed, ego, planar, n=120, n_out=20):
    from golden_scenarios import _golden_ground_points

    return _golden_ground_points(np.random.default_rng(seed), np.asarray(ego), n, n_out,
                                 planar)


@pytest.mark.parametrize("geometry", ["ods", "standard"])
def test_points_velocity_estimator_matches_jax(geometries, geometry):
    cfg, jcfg = geometries[geometry]
    port, ref = PointsVE(cfg, device="cpu"), JaxPointsVE(jcfg)
    port._draw_scores = JaxKeyStream(42)
    for seed, ego in enumerate(((0.4, -0.2, 1.0), (0.8, -0.3, 0.0))):
        pts = _ground_points(seed, ego, planar=geometry == "standard")
        valid = np.random.default_rng(seed).random(len(pts)) < 0.9
        for v in (None, valid):
            want = np.asarray(ref.process(points=pts, valid=v)).copy()
            got = np.asarray(port.process(points=pts, valid=v)).copy()
            np.testing.assert_allclose(got, want, rtol=0, atol=VELOCITY_ATOL)
            assert abs(port.estimated_R2 - ref.estimated_R2) <= 1e-4
    assert np.count_nonzero(got) >= 2


@pytest.mark.parametrize("only_2d", [True, False])
def test_vehicle_vel_estimator_matches_jax(only_2d):
    port, ref = VehicleVelEstimator(device="cpu"), JaxVehicle()
    port._draw_scores = JaxKeyStream(0, trials=100)
    for seed in range(2):
        pts = _ground_points(seed, (0.8, -0.3, 0.2), planar=only_2d)
        want = ref.estimate_ego_vel(pts, only_2D=only_2d)
        got = port.estimate_ego_vel(pts, only_2D=only_2d)
        np.testing.assert_allclose(got, want, rtol=0, atol=VELOCITY_ATOL)
        assert abs(port.best_error - ref.best_error) <= 1e-5
        init = np.asarray((0.8, -0.3, 0.2)[: 2 if only_2d else 3])
        np.testing.assert_allclose(port.estimate_ego_vel(pts, init, only_2D=only_2d),
                                   ref.estimate_ego_vel(pts, init, only_2D=only_2d),
                                   rtol=0, atol=VELOCITY_ATOL)
    assert port.estimate_ego_vel(pts[:5]).shape == (0,)


# --------------------------------------------------------------------------- #
# goldens
# --------------------------------------------------------------------------- #
def _golden(name):
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files if not k.startswith("meta_")}


def test_golden_velocity_adc_ods_through_the_port(geometries):
    """``velocity_adc_ods.npz`` with the scenario's ``run_ours`` body, the port's draws."""
    sc = SCENARIOS["velocity_adc_ods"]
    inputs = sc.make_inputs()
    ve = VelocityEstimator(geometries["ods"][0], device="cpu", **VE_KW)
    vels, az0 = [], None
    for i in range(len(inputs)):
        v = ve.process(adc_cube=inputs[f"virt_{i}"], altitude=VEL_ALTITUDE)
        vels.append(np.asarray(v, np.float64).copy())
        if i == 0:
            az0 = ve.azimuth_response_mag.numpy()
    sc.compare({"velocity": np.stack(vels), "az_resp_0": az0}, _golden("velocity_adc_ods"))


def test_golden_velocity_points_through_the_port(geometries):
    """``velocity_points.npz`` with the scenario's ``run_ours`` body, the port's draws."""
    sc = SCENARIOS["velocity_points"]
    inputs = sc.make_inputs()
    ods = PointsVE(geometries["ods"][0], min_R2_threshold=0.6, min_inlier_percent=0.6,
                   device="cpu")
    std = PointsVE(geometries["standard"][0], min_R2_threshold=0.5,
                   min_inlier_percent=0.5, device="cpu")
    vve = VehicleVelEstimator(points_per_fit=7, max_iters=100, fit_thresh=0.05,
                              num_close_pts=10, static_vel_thresh=0.2, device="cpu")
    got = {"out_3d": np.asarray(ods.process(points=inputs["pts_3d"]), np.float64),
           "out_2d": np.asarray(std.process(points=inputs["pts_2d"]), np.float64),
           "out_vehicle": np.asarray(vve.estimate_ego_vel(inputs["pts_2d"], only_2D=True),
                                     np.float64)}
    sc.compare(got, _golden("velocity_points"))


def test_golden_standard_1843_through_the_port(geometries):
    """``standard_1843.npz`` (its range-Doppler, Doppler-azimuth, 2D detection and velocity legs)."""
    from golden_scenarios import OS2D

    from mmwave_radar_processing_tpu_torch.processors import (
        RangeDopplerDetector2D,
        RangeDopplerProcessor,
    )

    cfg = geometries["standard"][0]
    virt = SCENARIOS["standard_1843"].make_inputs()["virt"]
    ve = VelocityEstimator(cfg, lower_range_bound=0.5, upper_range_bound=0.5, device="cpu")
    ve_out = ve.process(adc_cube=virt, altitude=1.2)
    got = {
        "rd_rx0": np.asarray(RangeDopplerProcessor(cfg, device="cpu").process(
            virt, rx_idx=0), np.float32),
        "da": DopplerAzimuthProcessor(cfg, num_angle_bins=64, device="cpu").process(
            virt, rx_antennas=list(range(8)), range_window=[0.5, 3.0]).numpy(),
        "dets_2d": np.atleast_2d(np.asarray(RangeDopplerDetector2D(
            cfg, cfar_type="os_cfar_2d", cfar_params=OS2D, device="cpu").process(virt), int)),
        "ve_az_resp": ve.azimuth_response_mag.numpy(),
        "ve_vx": np.asarray([ve.ego_vx_estimate], np.float64),
        "ve_out": np.asarray(ve_out, np.float64),
        "ve_r2": np.asarray([ve.azimuth_estimate_R2, ve.min_R2_threshold], np.float64),
    }
    SCENARIOS["standard_1843"].compare(got, _golden("standard_1843"))
