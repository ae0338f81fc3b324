"""The port's detector API (range, range-Doppler, altimeter, point clouds) against the JAX package's.

The same seeded numpy frames go through both on the CPU.  Tolerances, each
with its reason:

- zoom FFTs within 1e-4 of the spectrum's maximum: two float32 FFTs of
  length 128 and chirps whose phases reach ~100 rad in float32;
- range profiles and range-Doppler maps within rtol 1e-4 and atol 1e-4
  times the maximum: float32 FFTs by two libraries;
- peak indices and ``valid`` flags equal: comparisons, sorts and min/max
  only;
- altitude tracks from the same ``AltimeterState`` within 1e-4 m: the
  picked bin is a discrete decision, the zoom grid a float32 ``linspace``;
- detection sets equal and points within rtol 1e-4, atol 1e-5 (the golden
  scenario's bar): the OS thresholds are exact, the angles are argmax bins.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from golden_scenarios import (
    ALT_PARAMS, ALT_PROFILE, GOLDEN_DIR, GROUND_VEL, OS1D_RNG, OS1D_VEL, OS2D,
    PCG_2D_KW, PCG_GROUND_KW, SCENARIOS, _ground_cubes,
)
from mmwave_radar_processing_tpu.config import grids as jgrids
from mmwave_radar_processing_tpu.ops import czt as jczt, peaks as jpeaks
from mmwave_radar_processing_tpu.processors import altimeter as jalt
from mmwave_radar_processing_tpu.processors import detection as jdet
from mmwave_radar_processing_tpu.processors import point_cloud as jpc
from mmwave_radar_processing_tpu.processors import range_doppler as jrd
from mmwave_radar_processing_tpu.processors import range_resp as jrr
from mmwave_radar_processing_tpu.processors.virtual_array import (
    VirtualArrayReformatter as JaxReformatter,
)
from mmwave_radar_processing_tpu_torch import (
    Altimeter, AltimeterState, PointCloudGenerator, RangeDetector,
    RangeDopplerDetector2D, RangeDopplerDetectorSequential,
    RangeDopplerGroundDetector, RangeDopplerProcessor, RangeProcessor,
    VirtualArrayReformatter, get_range_doppler_detector_registry,
    load_detection_constants,
)
from mmwave_radar_processing_tpu_torch.ops import czt, peaks
from mmwave_radar_processing_tpu_torch.processors.detection import Detections
from mmwave_radar_processing_tpu_torch.processors.point_cloud import aoa_angles
from mmwave_radar_processing_tpu_torch.processors.range_doppler import range_doppler_map
from mmwave_radar_processing_tpu_torch.processors.range_resp import (
    coarse_range_fft, linspace,
)

torch.set_num_threads(2)

ALT_KW = {k: v for k, v in ALT_PARAMS.items() if k != "precise_est_enabled"}
RANGE_CFAR = dict(num_train=5, num_guard=3, rho=0.5, alpha=2.0)


def complex_cube(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def assert_spectra_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def virt_cubes(flagship_config):
    """The golden scenario's three reformatted frames (ground + two movers), complex128."""
    var = JaxReformatter(flagship_config)
    return [np.asarray(var.process(raw)).astype(np.complex128) for raw in _ground_cubes()]


# --------------------------------------------------------------------------- #
# chirp-z transform
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,m,f1,f2,fs", [(63, 63, 0.1, 0.4, 2.0), (63, 40, 1.7, 9.3, 25.0),
                                          (16, 33, -0.2, 0.3, 1.0)])
def test_zoom_fft_matches_jax(n, m, f1, f2, fs):
    x = complex_cube((3, 4, n), seed=n + m)
    want = jczt.zoom_fft(x, n=n, m=m, f1=f1, f2=f2, fs=fs)
    got = czt.zoom_fft(torch.from_numpy(x), n=n, m=m, f1=f1, f2=f2, fs=fs)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    moved = czt.zoom_fft(torch.from_numpy(x).movedim(-1, 0), n=n, m=m, f1=f1, f2=f2, fs=fs,
                         axis=0)
    assert torch.equal(moved.movedim(0, -1), got)
    dyn = czt.zoom_fft_dynamic(torch.from_numpy(x), torch.tensor(f1), torch.tensor(f2),
                               n=n, m=m, fs=fs)
    want_dyn = jczt.zoom_fft_dynamic(x, jnp.float32(f1), jnp.float32(f2), n=n, m=m, fs=fs)
    np.testing.assert_allclose(dyn.numpy(), np.asarray(want_dyn), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(dyn.numpy(), got.numpy(), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(want)).max())


def test_czt_factors_bit_equal_to_jax():
    for args in ((63, 63, 0.1, 0.4, 2.0), (63, 40, 1.7, 9.3, 25.0)):
        ours, theirs = czt.czt_factors(*args), jczt.czt_factors(*args)
        assert ours[3] == theirs[3]
        for a, b in zip(ours[:3], theirs[:3]):
            assert a.dtype == np.complex64
            np.testing.assert_array_equal(a, b)


def test_zoom_fft_checks_the_length():
    with pytest.raises(ValueError, match="expected n=63"):
        czt.zoom_fft(torch.zeros(4, 60, dtype=torch.complex64), n=63, f1=0.1, f2=0.2)


# --------------------------------------------------------------------------- #
# peaks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,max_peaks", [(63, 3), (63, 2), (5, 4), (128, 6)])
def test_top_peaks_within_threshold_matches_jax(n, max_peaks):
    rng = np.random.default_rng(n)
    rows = np.round(rng.normal(0.0, 12.0, (6, n)) * 2) / 2  # half-dB steps: ties
    rows[0] = 0.0  # no peak at all
    rows = rows.astype(np.float32)
    idx, vals, valid = peaks.top_peaks_within_threshold(
        torch.from_numpy(rows), max_peaks=max_peaks, min_prominence=6.0, threshold_db=20.0)
    assert idx.shape == vals.shape == valid.shape == (6, max_peaks)
    for r, row in enumerate(rows):
        ji, jv, jvalid = jpeaks.top_peaks_within_threshold(
            row, max_peaks=max_peaks, min_prominence=6.0, threshold_db=20.0)
        np.testing.assert_array_equal(idx[r].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(valid[r].numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(vals[r].numpy(), np.asarray(jv))
    assert bool(valid[1:].any()) and not bool(valid[0].any())


# --------------------------------------------------------------------------- #
# range and range-Doppler processors
# --------------------------------------------------------------------------- #
def test_coarse_range_fft_and_range_doppler_map_match_jax():
    cube = complex_cube((2, 4, 63, 70), seed=3)
    assert_spectra_close(coarse_range_fft(torch.from_numpy(cube[..., 0])),
                         jrr.coarse_range_fft(cube[..., 0]))
    assert_spectra_close(torch.view_as_real(range_doppler_map(torch.from_numpy(cube))),
                         np.asarray(jrd.range_doppler_map(cube)).view(np.float32).reshape(
                             2, 4, 63, 70, 2))


def test_linspace_matches_jnp():
    """Within one float32 ulp (XLA contracts ``a*(1-t) + b*t`` into an FMA); the ends are equal."""
    for start, stop, num in ((0.3, 0.7, 63), (1e-6, 2.9, 40), (0.5, 0.5, 1)):
        for got, want in (
                (linspace(start, stop, num, "cpu"), jnp.linspace(start, stop, num)),
                (linspace(torch.tensor(start), torch.tensor(stop), num, "cpu"),
                 jnp.linspace(jnp.float32(start), jnp.float32(stop), num))):
            got, want = got.numpy(), np.asarray(want)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
            assert got[0] == want[0] and got[-1] == want[-1]


def test_range_processor_matches_jax(flagship_config, virt_cubes):
    ours, theirs = RangeProcessor(flagship_config, device="cpu"), jrr.RangeProcessor(flagship_config)
    np.testing.assert_array_equal(ours.range_bins, theirs.range_bins)
    cube = virt_cubes[1]
    profile = ours.process(cube)
    assert profile.dtype == torch.float32
    assert_spectra_close(profile, theirs.process(jnp.asarray(cube)))
    assert_spectra_close(ours.coarse_fft(cube, chirp_idx=5),
                         theirs.coarse_fft(jnp.asarray(cube), chirp_idx=5))
    # a static band (Python numbers) and the same band as tensors
    mag, bins = ours.zoom_fft(cube, 0.5, 1.3, num_bins=48)
    jmag, jbins = theirs.zoom_fft(jnp.asarray(cube), 0.5, 1.3, num_bins=48)
    assert_spectra_close(mag, jmag)
    np.testing.assert_allclose(bins.numpy(), np.asarray(jbins), rtol=2e-7, atol=0)
    assert len(ours._czt_factors) == 1
    dmag, dbins = ours.zoom_fft(cube, torch.tensor(0.5), torch.tensor(1.3), num_bins=48)
    jdmag, _ = theirs.zoom_fft(jnp.asarray(cube), jnp.float32(0.5), jnp.float32(1.3), num_bins=48)
    assert_spectra_close(dmag, jdmag)
    assert torch.equal(dbins, bins)
    db = 20.0 * torch.log10(profile + 1e-12)
    ranges, vals, valid = ours.find_peaks(db, ours._range_bins_t)
    jranges, jvals, jvalid = theirs.find_peaks(jnp.asarray(db.numpy()), jnp.asarray(theirs.range_bins))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(ranges.numpy(), np.asarray(jranges))
    assert bool(valid.any())


def test_range_doppler_processor_matches_jax(flagship_config, virt_cubes):
    ours = RangeDopplerProcessor(flagship_config, device="cpu")
    theirs = jrd.RangeDopplerProcessor(flagship_config)
    np.testing.assert_array_equal(ours.range_bins, theirs.range_bins)
    np.testing.assert_array_equal(ours.vel_bins, theirs.vel_bins)
    cube = virt_cubes[0]
    assert_spectra_close(ours.process(cube, rx_idx=0), theirs.process(cube, rx_idx=0))
    every = ours.process(torch.from_numpy(cube), rx_idx=-1, return_magnitude=False)
    assert every.dtype == torch.complex64 and every.shape == (12, 63, 70)
    want = np.asarray(theirs.process(cube, rx_idx=-1, return_magnitude=False))
    assert_spectra_close(torch.view_as_real(every), want.view(np.float32).reshape(12, 63, 70, 2))
    raw = _ground_cubes()[0]  # a raw cube has another chirp count than a reformatted one
    assert ours.process(raw).shape == (63, 210)


def test_virtual_array_reformatter_matches_jax(flagship_config):
    raw = _ground_cubes()[0]
    got = VirtualArrayReformatter(flagship_config, device="cpu").process(raw)
    want = np.asarray(JaxReformatter(flagship_config).process(raw.astype(np.complex64)))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# altimeter
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("precise", [True, False], ids=["precise", "coarse"])
def test_altimeter_tracks_a_gradual_profile_like_jax(flagship_config, precise):
    inputs = SCENARIOS["altimeter_ods"].make_inputs()
    cubes = [inputs[f"cube_{i}"] for i in range(len(ALT_PROFILE))]
    ours = Altimeter(flagship_config, device="cpu", **ALT_KW)
    theirs = jalt.Altimeter(flagship_config, **ALT_KW)
    # both start from the same state, not from min_altitude_m
    start = np.float32(ALT_PROFILE[0] - 0.1)
    state, jstate = ours.init_state(start), jalt.AltimeterState(jnp.asarray(start))
    assert isinstance(state, AltimeterState)
    assert state.altitude_measured_m.dtype == torch.float32
    track, jtrack = [], []
    for cube in cubes:
        state, corrected = ours.step(state, cube, precise_est_enabled=precise)
        jstate, jcorrected = theirs.step(jstate, jnp.asarray(cube), precise)
        track.append(float(corrected))
        jtrack.append(float(jcorrected))
    np.testing.assert_allclose(track, jtrack, rtol=0, atol=1e-4)
    np.testing.assert_allclose(track, ALT_PROFILE, atol=0.1)


def test_altimeter_scan_equals_stepping_and_reset(flagship_config):
    inputs = SCENARIOS["altimeter_ods"].make_inputs()
    cubes = np.stack([inputs[f"cube_{i}"] for i in range(4)])
    alt = Altimeter(flagship_config, device="cpu", **ALT_KW)
    final, track = alt.scan(cubes)
    stepped = [float(alt.process(c)) for c in cubes]
    np.testing.assert_array_equal(track.numpy(), np.asarray(stepped, np.float32))
    assert float(final.altitude_measured_m) == alt.current_altitude_measured_m
    assert alt.current_altitude_corrected_m == alt.current_altitude_measured_m + alt.range_bias
    assert alt.coarse_fft_data.shape == (63,)
    alt.reset()
    assert alt.current_altitude_measured_m == pytest.approx(ALT_KW["min_altitude_m"])


def test_altimeter_golden(flagship_config):
    scenario = SCENARIOS["altimeter_ods"]
    inputs = scenario.make_inputs()
    alt = Altimeter(flagship_config, device="cpu", **ALT_KW)
    track = [float(alt.process(inputs[f"cube_{i}"], precise_est_enabled=True))
             for i in range(len(ALT_PROFILE))]
    golden = dict(np.load(os.path.join(GOLDEN_DIR, "altimeter_ods.npz")))
    scenario.compare({"track": np.asarray(track, np.float64)}, golden)


# --------------------------------------------------------------------------- #
# detectors and point clouds
# --------------------------------------------------------------------------- #
def _detector_pairs(cfg):
    ground = dict(vel_cfar_type="os_cfar_1d", vel_cfar_params=GROUND_VEL,
                  altimeter_params=ALT_PARAMS)
    seq = dict(rng_cfar_type="os_cfar_1d", rng_cfar_params=OS1D_RNG,
               vel_cfar_type="os_cfar_1d", vel_cfar_params=OS1D_VEL)
    return {
        "range": (RangeDetector, jdet.RangeDetector,
                  dict(cfar_type="os_cfar_1d", cfar_params=RANGE_CFAR)),
        "rd_2d_os": (RangeDopplerDetector2D, jdet.RangeDopplerDetector2D,
                     dict(cfar_type="os_cfar_2d", cfar_params=OS2D)),
        "rd_2d_default": (RangeDopplerDetector2D, jdet.RangeDopplerDetector2D, {}),
        "sequential": (RangeDopplerDetectorSequential, jdet.RangeDopplerDetectorSequential, seq),
        "sequential_default": (RangeDopplerDetectorSequential,
                               jdet.RangeDopplerDetectorSequential, {}),
        "ground": (RangeDopplerGroundDetector, jdet.RangeDopplerGroundDetector, ground),
    }


@pytest.mark.parametrize("name", ["range", "rd_2d_os", "rd_2d_default", "sequential",
                                  "sequential_default", "ground"])
def test_detectors_match_jax(flagship_config, virt_cubes, name):
    ours_cls, theirs_cls, kw = _detector_pairs(flagship_config)[name]
    ours, theirs = ours_cls(flagship_config, device="cpu", **kw), theirs_cls(flagship_config, **kw)
    total = 0
    for cube in virt_cubes:
        got, want = ours.process(cube), np.asarray(theirs.process(cube))
        np.testing.assert_array_equal(got, want)
        total += len(want)
    assert total > 0
    if name == "ground":
        assert ours.altimeter.current_altitude_measured_m == pytest.approx(
            theirs.altimeter.current_altitude_measured_m, abs=1e-4)
        ours.reset()
        assert ours.dets is None and ours.altimeter.current_altitude_measured_m == pytest.approx(0.25)
    if name == "range":
        np.testing.assert_array_equal(ours._map_detections_to_bins(got),
                                      theirs._map_detections_to_bins(want))
    elif name == "rd_2d_os":
        for a, b in zip(ours._map_detections_to_bins(got), theirs._map_detections_to_bins(want)):
            np.testing.assert_array_equal(a, b)
        assert all(a.size == 0 for a in ours._map_detections_to_bins(np.zeros((0, 2))))


def test_device_resident_detections_and_ground_step(flagship_config, virt_cubes):
    kw = dict(vel_cfar_type="os_cfar_1d", vel_cfar_params=GROUND_VEL, altimeter_params=ALT_PARAMS)
    ours = RangeDopplerGroundDetector(flagship_config, device="cpu", max_dets=40, **kw)
    theirs = jdet.RangeDopplerGroundDetector(flagship_config, max_dets=40, **kw)
    state, jstate = ours.altimeter.init_state(), theirs.altimeter.init_state()
    for cube in virt_cubes:
        state, dets = ours.step(state, cube)
        jstate, jdets = theirs.step(jstate, jnp.asarray(cube))
        assert isinstance(dets, Detections) and dets.range_idx.shape == (40,)
        for a, b in zip(dets, jdets):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    det2d = RangeDopplerDetector2D(flagship_config, device="cpu", cfar_type="os_cfar_2d",
                                   cfar_params=OS2D)
    padded = det2d.detections(virt_cubes[0])
    listed = det2d.process(virt_cubes[0])
    np.testing.assert_array_equal(
        torch.stack([padded.range_idx, padded.vel_idx], 1)[padded.valid].numpy(), listed)
    assert int(padded.count) == len(listed)


@pytest.mark.parametrize("aoa_method", ["fft", "capon"])
@pytest.mark.parametrize("kind", ["2d", "ground"])
def test_point_cloud_generator_matches_jax(flagship_config, virt_cubes, kind, aoa_method):
    kw = PCG_2D_KW if kind == "2d" else PCG_GROUND_KW
    ours = PointCloudGenerator(flagship_config, aoa_method=aoa_method, device="cpu", **kw)
    theirs = jpc.PointCloudGenerator(flagship_config, aoa_method=aoa_method, **kw)
    np.testing.assert_array_equal(ours.angle_bins, theirs.angle_bins)
    np.testing.assert_array_equal(ours.phase_shifts, theirs.phase_shifts)
    for cube in virt_cubes:
        got, want = ours.process(cube), np.asarray(theirs.process(cube))
        assert got.shape == want.shape and got.dtype == np.float32 and len(want) > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    cloud = ours.point_cloud(virt_cubes[0])
    assert cloud.points.shape == (256, 4) and int(cloud.count) == int(cloud.valid.sum())
    assert not bool(cloud.points[~cloud.valid].any())


def test_point_cloud_generator_options(flagship_config, virt_cubes):
    with pytest.raises(ValueError, match="aoa_method"):
        PointCloudGenerator(flagship_config, [0, 3], [9, 8], aoa_method="music", device="cpu")
    with pytest.raises(ValueError, match="Unknown detector type"):
        PointCloudGenerator(flagship_config, [0, 3], [9, 8], detector_type="none", device="cpu")
    with pytest.raises(TypeError):
        PointCloudGenerator(flagship_config, [0, 3], [9, 8])
    assert tuple(get_range_doppler_detector_registry()) == tuple(
        jdet.get_range_doppler_detector_registry())
    # no elevation subset: zero elevation, as in the JAX package
    kw = dict(PCG_2D_KW, el_antenna_idxs=[])
    got = PointCloudGenerator(flagship_config, device="cpu", **kw).process(virt_cubes[0])
    want = np.asarray(jpc.PointCloudGenerator(flagship_config, **kw).process(virt_cubes[0]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert not got[:, 2].any()


def test_aoa_angles_match_jax():
    rd = complex_cube((12, 20, 16), seed=5)
    r_idx, v_idx = np.array([0, 3, 19, 7]), np.array([1, 15, 0, 8])
    bins = jgrids.angle_bins(64).astype(np.float32)
    for shift in (True, False):
        got = aoa_angles(torch.from_numpy(rd), torch.tensor([0, 3, 4, 7]), torch.from_numpy(r_idx),
                         torch.from_numpy(v_idx), torch.from_numpy(bins), num_angle_bins=64,
                         shift=shift)
        want = jpc.aoa_angles(rd, jnp.asarray([0, 3, 4, 7]), r_idx, v_idx, jnp.asarray(bins),
                              num_angle_bins=64, shift=shift)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_golden_rd_detection_pointcloud(flagship_config):
    """``rd_detection_pointcloud_ods.npz``: the scenario's ``_run`` body with the port's classes."""
    scenario = SCENARIOS["rd_detection_pointcloud_ods"]
    inputs = scenario.make_inputs()
    cfg = flagship_config
    on_cpu = functools.partial
    cubes = [inputs[f"virt_{i}"] for i in range(3)]
    out = {}
    rd1 = on_cpu(RangeDetector, device="cpu")(cfg, cfar_type="os_cfar_1d", cfar_params=RANGE_CFAR)
    det2d = on_cpu(RangeDopplerDetector2D, device="cpu")(cfg, cfar_type="os_cfar_2d",
                                                        cfar_params=OS2D)
    seq = on_cpu(RangeDopplerDetectorSequential, device="cpu")(
        cfg, rng_cfar_type="os_cfar_1d", rng_cfar_params=OS1D_RNG,
        vel_cfar_type="os_cfar_1d", vel_cfar_params=OS1D_VEL)
    ground = on_cpu(RangeDopplerGroundDetector, device="cpu")(
        cfg, vel_cfar_type="os_cfar_1d", vel_cfar_params=GROUND_VEL, altimeter_params=ALT_PARAMS)
    pcg_ground = PointCloudGenerator(cfg, device="cpu", **PCG_GROUND_KW)
    pcg_2d = PointCloudGenerator(cfg, device="cpu", **PCG_2D_KW)
    for i, cube in enumerate(cubes):
        out[f"rng_dets_{i}"] = np.sort(np.asarray(rd1.process(cube), int).reshape(-1))
        out[f"rd2d_dets_{i}"] = np.atleast_2d(np.asarray(det2d.process(cube), int))
        out[f"seq_dets_{i}"] = np.atleast_2d(np.asarray(seq.process(cube), int))
        out[f"ground_dets_{i}"] = np.atleast_2d(np.asarray(ground.process(cube), int))
    # point clouds need fresh stateful detectors (altimeter state)
    for i, cube in enumerate(cubes):
        out[f"pcg_ground_pts_{i}"] = np.asarray(pcg_ground.process(cube), np.float64).reshape(-1, 4)
        out[f"pcg_2d_pts_{i}"] = np.asarray(pcg_2d.process(cube), np.float64).reshape(-1, 4)
    golden = dict(np.load(os.path.join(GOLDEN_DIR, "rd_detection_pointcloud_ods.npz")))
    scenario.compare(out, golden)


# --------------------------------------------------------------------------- #
# constants carried across
# --------------------------------------------------------------------------- #
def test_constants_equal_jax_and_load(flagship_config, virt_cubes):
    theirs = jpc.PointCloudGenerator(flagship_config, aoa_method="capon", **PCG_GROUND_KW)
    ours = PointCloudGenerator(flagship_config, aoa_method="capon", device="cpu", **PCG_GROUND_KW)
    band = (63, 0.5 * theirs.detector.altimeter._zoom_scale, 1.3 * theirs.detector.altimeter._zoom_scale)
    awk2, fwk2, wk2_m, _ = jczt.czt_factors(63, band[0], band[1], band[2],
                                            theirs.detector.altimeter._zoom_fs)
    jax_side = {
        "range_bins_plain": np.asarray(theirs.detector.altimeter.range_bins),
        "range_bins_eps": np.asarray(theirs.detector.range_bins),
        "vel_bins": np.asarray(theirs.detector.vel_bins),
        "angle_bins": np.asarray(theirs.angle_bins),
        "phase_shifts": np.asarray(theirs.phase_shifts),
        "czt_band": np.asarray(band), "czt_awk2": awk2, "czt_fwk2": fwk2, "czt_wk2_m": wk2_m,
    }
    # the port's own copies equal them bit for bit
    alt = ours.detector.altimeter
    np.testing.assert_array_equal(alt.range_bins, jax_side["range_bins_plain"])
    np.testing.assert_array_equal(ours.detector.range_bins, jax_side["range_bins_eps"])
    np.testing.assert_array_equal(ours.detector.vel_bins, jax_side["vel_bins"])
    np.testing.assert_array_equal(ours.angle_bins, jax_side["angle_bins"])
    np.testing.assert_array_equal(ours.phase_shifts, jax_side["phase_shifts"])
    for mine, want in zip(alt.static_czt_factors(63, band[1], band[2]), (awk2, fwk2, wk2_m)):
        np.testing.assert_array_equal(mine.numpy(), want)
    np.testing.assert_array_equal(ours._az_steering.real.numpy(), np.asarray(theirs._az_steering.re))
    np.testing.assert_array_equal(ours._az_steering.imag.numpy(), np.asarray(theirs._az_steering.im))

    before = ours.process(virt_cubes[0])
    ours.reset()
    load_detection_constants(ours, jax_side)
    np.testing.assert_array_equal(ours.process(virt_cubes[0]), before)
    # loaded values are used: shifted velocity bins move the fourth column
    load_detection_constants(ours, {"vel_bins": jax_side["vel_bins"] + 1.0})
    ours.reset()
    np.testing.assert_allclose(ours.process(virt_cubes[0])[:, 3], before[:, 3] + 1.0, atol=1e-6)

    with pytest.raises(ValueError, match="no object here takes"):
        load_detection_constants(RangeProcessor(flagship_config, device="cpu"),
                                 {"vel_bins": jax_side["vel_bins"]})
    with pytest.raises(ValueError, match="shape"):
        load_detection_constants(ours, {"angle_bins": np.zeros(32)})
    with pytest.raises(ValueError, match="come together"):
        load_detection_constants(alt, {"czt_band": np.asarray(band)})


def test_config_of_either_package_builds_the_same_processors(flagship_config, virt_cubes):
    from mmwave_radar_processing_tpu_torch import load_cfg

    here = os.path.dirname(__file__)
    own = load_cfg(os.path.join(here, "..", "configs", "6843_RadVel_ods_20Hz.cfg"),
                   array_geometry="ods", array_direction="down")
    a = PointCloudGenerator(own, device="cpu", **PCG_2D_KW).process(virt_cubes[2])
    b = PointCloudGenerator(flagship_config, device="cpu", **PCG_2D_KW).process(virt_cubes[2])
    np.testing.assert_array_equal(a, b)
