"""The port's synthetic-aperture beamformer against the JAX package's, on the CPU.

``processors/synthetic_array.py`` function by function (gate, geometry,
beamforming, array factor, the unwrap helper, calibration, cartesian
resampling), the processor over recordings, the batched pipeline
(``parallel/beamform_pipeline.py``) against the JAX scan and against a loop
of the port's own ``step``, a resume from a JAX mid-recording state, and the
golden ``sar_ods`` (strip map, DBS and synthetic aperture) through the port.
Inputs are seeded simulated frames, the same numpy arrays on both sides.
Bars:

- maps: rtol ``MAP_RTOL`` = 1e-4 with atol 1e-4 times the map's maximum;
- exact: gates (``ok``, ``array_geometry_valid``), the unwrap's 2*pi
  counts, the resampling weights' use (same numpy code) and the resampled
  map given the same input;
- geometry: rtol 1e-5, atol 1e-8 (float32 running sums in another order);
  the array factor rtol and atol 1e-4: the golden's bars;
- calibrated geometry: rtol 1e-3, atol 1e-5, and the map after it rtol and
  atol 5e-3 of the maximum: the golden's bars (a 3x2 least squares per
  element, SVD on both sides, then a running sum over 209 elements);
- unwrapped phases: the counts of 2*pi exact, the values within float32
  rounding of a running sum (numpy, JAX and torch sum in other orders).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from golden_scenarios import GOLDEN_DIR, SA_KW, SA_VEL, SCENARIOS, STANDARD_CFG, input_sha
from mmwave_radar_processing_tpu.config import load_cfg as jax_load_cfg
from mmwave_radar_processing_tpu.data import PointTarget, Scene, simulate_frames
from mmwave_radar_processing_tpu.parallel.beamform_pipeline import (
    build_synthetic_aperture_pipeline as build_jax,
)
from mmwave_radar_processing_tpu.processors import synthetic_array as jsa
from mmwave_radar_processing_tpu_torch import (
    RangeAngleProcessorDBSEnhanced,
    StripMapSARProcessor,
    SyntheticArrayBeamformerProcessor,
    VirtualArrayReformatter,
    build_synthetic_aperture_pipeline,
    load_cfg,
)
from mmwave_radar_processing_tpu_torch.processors import synthetic_array as psa

torch.set_num_threads(2)  # tier-1 runs several xdist workers

MAP_RTOL = 1e-4
GEOMETRY_TOL = dict(rtol=1e-5, atol=1e-8)
CAL_GEOMETRY_TOL = dict(rtol=1e-3, atol=1e-5)
AZ = np.deg2rad(np.linspace(-30, 30, 40))
EL = np.array([0.0])
PROC_KW = dict(SA_KW, az_angle_bins_rad=AZ, el_angle_bins_rad=EL)
N_FRAMES = 7


def assert_maps_close(got, want, rtol=MAP_RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def cfgs(flagship_cfg_path):
    return {g: (load_cfg(p, array_geometry=g, array_direction="down"),
                jax_load_cfg(p, array_geometry=g, array_direction="down"))
            for g, p in (("ods", flagship_cfg_path), ("standard", STANDARD_CFG))}


def _velocities(track):
    """``[N_FRAMES, 3]`` float64 platform velocities: a steady track, or one with a step."""
    vel = np.tile(SA_VEL, (N_FRAMES, 1))
    if track == "step":
        vel[3:5] = (0.45, 0.01, 0.0)  # above max_vel: the gate rejects frames 3-6
    return vel


@pytest.fixture(scope="module")
def recording(cfgs):
    """``N_FRAMES`` raw complex128 frames of three reflectors (one moving)."""
    scenes = [Scene(targets=[
        PointTarget(range_m=1.0 + 0.05 * i, rcs=4.0),
        PointTarget(range_m=1.8, azimuth_rad=0.3, velocity_m_s=0.4, rcs=2.0),
        PointTarget(range_m=2.6, azimuth_rad=-0.2, velocity_m_s=-0.3, rcs=2.0),
    ], noise_sigma=0.03) for i in range(N_FRAMES)]
    return simulate_frames(cfgs["ods"][1], scenes, np.random.default_rng(21))


# --------------------------------------------------------------------------- #
# pure functions
# --------------------------------------------------------------------------- #
GATE_CASES = {
    "passing": [[0.2, 0.01, 0.0], [0.21, 0.0, 0.01], [0.19, 0.02, 0.0]],
    "below_min": [[0.2, 0.01, 0.0], [0.1, 0.0, 0.0], [0.2, 0.0, 0.0]],
    "above_max": [[0.2, 0.01, 0.0], [0.2, 0.06, 0.0], [0.2, 0.0, 0.0]],
    "stdev": [[0.16, 0.0, 0.0], [0.29, 0.0, 0.0], [0.16, 0.0, 0.0]],
    "direction": [[0.2, 0.04, 0.0], [-0.2, 0.0, 0.0], [0.2, 0.0, 0.0]],
    "zeros": [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.2, 0.01, 0.0]],
}
GATE_BOUNDS = dict(min_vel=np.array([0.15, 0.0, 0.0]), max_vel=np.array([0.3, 0.05, 0.05]),
                   max_vel_stdev=np.array([0.1, 0.1, 0.1]))
TIGHT_STDEV = dict(GATE_BOUNDS, max_vel_stdev=np.array([0.05, 0.1, 0.1]))


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_velocity_gate_equals_jax(case):
    """Each way to fail: a bound, the spread (tight stdev), a reversed direction, the zero start."""
    hist = np.asarray(GATE_CASES[case], np.float32)
    bounds = TIGHT_STDEV if case == "stdev" else GATE_BOUNDS
    got = psa.velocity_gate(torch.from_numpy(hist), **bounds)
    want = bool(jsa.velocity_gate(jnp.asarray(hist), **bounds))
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == want == (case == "passing")
    if case == "stdev":  # only the spread fails it
        assert bool(psa.velocity_gate(torch.from_numpy(hist), **GATE_BOUNDS))


def test_velocity_gate_batches_over_windows():
    hists = np.stack([np.asarray(GATE_CASES[c], np.float32) for c in GATE_CASES])
    got = psa.velocity_gate(torch.from_numpy(hists), **GATE_BOUNDS)
    want = [bool(jsa.velocity_gate(jnp.asarray(h), **GATE_BOUNDS)) for h in hists]
    assert got.tolist() == want


def test_chained_geometry_equals_jax(cfgs):
    proc = SyntheticArrayBeamformerProcessor(cfgs["ods"][0], device="cpu", **PROC_KW)
    hist = np.asarray([[0.2, 0.01, 0.0], [0.22, -0.01, 0.005], [0.18, 0.02, 0.0]], np.float32)
    t = proc.chirp_start_times_us * 1e-6
    got = psa.chained_geometry(torch.from_numpy(hist), torch.from_numpy(t.astype(np.float32)),
                               proc.frame_period_ms * 1e-3)
    want = jsa.chained_geometry(jnp.asarray(hist), jnp.asarray(t, jnp.float32),
                                proc.frame_period_ms * 1e-3)
    assert got.shape == (3, 3, proc.n_valid_chirps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEOMETRY_TOL)
    batched = psa.chained_geometry(torch.from_numpy(np.stack([hist, hist[::-1].copy()])),
                                   torch.from_numpy(t.astype(np.float32)),
                                   proc.frame_period_ms * 1e-3)
    assert torch.equal(batched[0], got)


@pytest.fixture(scope="module")
def beam_inputs(cfgs):
    """Seeded data ``(ns, E)``, positions ``(3, E)`` and the steering ``(A, 3)`` of the processor."""
    proc = SyntheticArrayBeamformerProcessor(cfgs["ods"][0], device="cpu", **PROC_KW)
    rng = np.random.default_rng(4)
    e = 3 * proc.n_valid_chirps
    data = (rng.standard_normal((63, e)) + 1j * rng.standard_normal((63, e))).astype(np.complex64)
    positions = (rng.uniform(-0.05, 0.05, (3, e))).astype(np.float32)
    return proc, data, positions, proc._steering_flat.astype(np.float32)


def test_beamform_equals_jax(beam_inputs):
    proc, data, positions, steering = beam_inputs
    rw, ew = proc._range_window, proc._element_window
    got = psa.beamform(*map(torch.from_numpy, (data, positions, steering)), proc.lambda_m,
                       torch.from_numpy(rw), torch.from_numpy(ew))
    want = jsa.beamform(jnp.asarray(data), jnp.asarray(positions), jnp.asarray(steering),
                        proc.lambda_m, jnp.asarray(rw), jnp.asarray(ew))
    assert got.shape == (63, 40) and got.dtype == torch.complex64
    assert_maps_close(got.abs(), np.abs(np.asarray(want)))


def test_array_factor_pattern_equals_jax(beam_inputs):
    proc, _, positions, steering = beam_inputs
    got = psa.array_factor_pattern(torch.from_numpy(positions), torch.from_numpy(steering),
                                   proc.lambda_m)
    want = jsa.array_factor_pattern(jnp.asarray(positions), jnp.asarray(steering), proc.lambda_m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert float(got.max()) == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unwrap_equals_numpy_and_jax(seed):
    """Random walks of wrapped phases, steps near pi, and an exact step of pi after reduction."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(0.0, 2.0, (3, 300)), axis=1)
    p = np.angle(np.exp(1j * walk)).astype(np.float32)
    p[:, 10] = p[:, 9] + np.float32(np.pi)  # |d| == pi exactly: corrected
    p[:, 20] = p[:, 19] - np.float32(np.pi)
    p[:, 30] = p[:, 29] + np.float32(3.1415)  # just under pi: left alone
    got = psa.unwrap(torch.from_numpy(p), dim=1).numpy()
    for want in (np.unwrap(p, axis=1), np.asarray(jnp.unwrap(jnp.asarray(p), axis=1))):
        assert want.dtype == np.float32
        assert np.array_equal(np.round((got - p) / (2 * np.pi)), np.round((want - p) / (2 * np.pi)))
        np.testing.assert_allclose(got, want, rtol=0, atol=8 * np.finfo(np.float32).eps
                                   * np.abs(want).max())
    assert np.array_equal(psa.unwrap(torch.from_numpy(p.T.copy()), dim=0).numpy(), got.T)


# --------------------------------------------------------------------------- #
# the processor
# --------------------------------------------------------------------------- #
def _pair(cfgs, **kw):
    pcfg, jcfg = cfgs["ods"]
    kw = dict(PROC_KW, **kw)
    return (SyntheticArrayBeamformerProcessor(pcfg, device="cpu", **kw),
            jsa.SyntheticArrayBeamformerProcessor(jcfg, **kw))


def test_processor_constants_equal_jax(cfgs):
    port, ref = _pair(cfgs)
    for name in ("valid_chirps_mask", "chirp_start_times_us", "range_bins", "d", "x_s", "y_s",
                 "z_s", "interp_x_s", "interp_y_s", "_element_window", "_range_window"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    for key, value in ref._interp.items():
        assert np.array_equal(port._interp[key], value), key
    default_port = SyntheticArrayBeamformerProcessor(cfgs["ods"][0], device="cpu")
    default_ref = jsa.SyntheticArrayBeamformerProcessor(cfgs["ods"][1])
    assert default_port.num_frames == default_ref.num_frames == 2
    assert np.array_equal(default_port.min_vel, default_ref.min_vel)


@pytest.mark.parametrize("calibrate", [False, True], ids=["plain", "calibrated"])
@pytest.mark.parametrize("track", ["steady", "step"])
def test_processor_over_a_recording_equals_jax(cfgs, recording, calibrate, track):
    port, ref = _pair(cfgs, enable_calibration=calibrate, num_calibration_iters=2)
    n_valid = 0
    for cube, vel in zip(recording, _velocities(track)):
        got = port.process(cube, current_vel=vel)
        want = ref.process(cube.copy(), current_vel=vel)
        assert port.array_geometry_valid == ref.array_geometry_valid
        np.testing.assert_allclose(port.array_geometry, ref.array_geometry, **GEOMETRY_TOL)
        if not ref.array_geometry_valid:
            assert got.shape == want.shape == (0,)
            continue
        n_valid += 1
        assert got.shape == want.shape == (63, 40, 1) and got.dtype == np.complex64
        if calibrate:
            np.testing.assert_allclose(port.array_geometry_calibrated,
                                       ref.array_geometry_calibrated, **CAL_GEOMETRY_TOL)
            assert_maps_close(np.abs(got), np.abs(want), rtol=5e-3)
            assert_maps_close(port.interpolated_beamformed_resp,
                              ref.interpolated_beamformed_resp, rtol=5e-3)
        else:
            assert_maps_close(np.abs(got), np.abs(want))
            assert_maps_close(np.abs(port.interpolated_beamformed_resp),
                              np.abs(ref.interpolated_beamformed_resp))
    assert n_valid == (5 if track == "steady" else 1)
    port.reset()
    assert not port.array_geometry_valid and not port.state.vel_history.any()


def _jax_targets(ref, geometry, beamformed):
    """The reflector picks of the JAX ``perform_array_calibration``, in its own operations."""
    from mmwave_radar_processing_tpu.ops import peaks as jpeaks

    data, _ = ref._flatten(ref.state, jnp.asarray(geometry))
    freq = jnp.fft.fft(data * jnp.asarray(ref._element_window)[None, :], axis=0)
    avg_db = jnp.mean(20.0 * jnp.log10(jnp.abs(freq) + 1e-12), axis=1)
    pk = jpeaks.local_maxima(avg_db) & (avg_db > 0)
    rng_idx = jax.lax.top_k(jnp.where(pk, avg_db, -jnp.inf), 3)[1]
    az_db = jnp.abs(10.0 * jnp.log10(jnp.abs(jnp.asarray(beamformed)[:, :, 0])[rng_idx] + 1e-12))
    az_idx = [int(jnp.argmax(jnp.where(jpeaks.local_maxima(row), row, -jnp.inf)))
              for row in az_db]
    return np.asarray(rng_idx).tolist(), az_idx


def test_calibration_equals_jax_on_the_same_state(cfgs, recording):
    """One ``perform_array_calibration`` from the JAX processor's own state, geometry and map."""
    port, ref = _pair(cfgs)
    for cube in recording[:4]:
        ref.process(cube.copy(), current_vel=SA_VEL)
    state = port.state_from_jax(np.asarray(ref.state.adc_history),
                                np.asarray(ref.state.vel_history))
    geometry, beamformed = ref.array_geometry, np.array(ref.beamformed_resp)
    got, ok = port.perform_array_calibration(state, torch.from_numpy(geometry.astype(np.float32)),
                                             torch.from_numpy(beamformed))
    want, want_ok = ref.perform_array_calibration(ref.state, jnp.asarray(geometry),
                                                  jnp.asarray(beamformed))
    assert bool(ok) == bool(want_ok) is True
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CAL_GEOMETRY_TOL)
    targets = port.calibration_targets(state, torch.from_numpy(geometry.astype(np.float32)),
                                       torch.from_numpy(beamformed))
    assert bool(targets.ok) and targets.rng_idx.tolist() == _jax_targets(ref, geometry,
                                                                       beamformed)[0]
    assert targets.az_idx.tolist() == _jax_targets(ref, geometry, beamformed)[1]
    assert np.abs(got.numpy() - geometry).max() > 1e-4  # the correction is not vacuous

    # a target-free aperture: fewer than three peaks, ok is False on both sides
    empty = port.state_from_jax(np.zeros_like(np.asarray(ref.state.adc_history)),
                                np.asarray(ref.state.vel_history))
    zeros = np.zeros_like(beamformed)
    _, ok = port.perform_array_calibration(empty, torch.from_numpy(geometry.astype(np.float32)),
                                           torch.from_numpy(zeros))
    _, want_ok = ref.perform_array_calibration(
        jsa.SyntheticArrayState(jnp.zeros_like(ref.state.adc_history), ref.state.vel_history),
        jnp.asarray(geometry), jnp.asarray(zeros))
    assert bool(ok) == bool(want_ok) is False


def test_interpolation_and_pattern_equal_jax(cfgs, recording):
    port, ref = _pair(cfgs)
    for cube in recording[:3]:
        ref.process(cube.copy(), current_vel=SA_VEL)
    resp = ref.beamformed_resp
    assert np.array_equal(port.get_interpolated_response_cart(resp),
                          ref.get_interpolated_response_cart(resp))
    np.testing.assert_allclose(port.compute_synthetic_array_pattern(ref.array_geometry),
                               ref.compute_synthetic_array_pattern(ref.array_geometry),
                               rtol=1e-4, atol=1e-4)


def test_processor_resumes_from_a_jax_state(cfgs, recording):
    """``state_from_jax``: the port takes over a recording from the JAX processor's ring buffers."""
    port, ref = _pair(cfgs)
    for cube in recording[:3]:
        ref.process(cube.copy(), current_vel=SA_VEL)
    port.state = port.state_from_jax(np.asarray(ref.state.adc_history),
                                     np.asarray(ref.state.vel_history))
    for cube in recording[3:]:
        got = port.process(cube, current_vel=SA_VEL)
        want = ref.process(cube.copy(), current_vel=SA_VEL)
        assert port.array_geometry_valid and ref.array_geometry_valid
        assert_maps_close(np.abs(got), np.abs(want))
    with pytest.raises(ValueError, match="state shape"):
        port.state_from_jax(np.zeros((2, 63, 70), np.complex64), np.zeros((2, 3)))


# --------------------------------------------------------------------------- #
# the batched pipeline
# --------------------------------------------------------------------------- #
def _planes(raw):
    return np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32)


@pytest.mark.parametrize("track", ["steady", "step"])
@pytest.mark.parametrize("geometry", ["ods", "standard"])
def test_pipeline_equals_jax(cfgs, recording, track, geometry):
    pcfg, jcfg = cfgs[geometry]
    raw = recording[..., :pcfg.chirps_per_frame]  # the standard config's 200 chirps
    raw_re, raw_im = _planes(raw)
    vel = _velocities(track)
    kw = dict(az_angle_bins_rad=AZ)
    mag, ok = build_synthetic_aperture_pipeline(pcfg, device="cpu", **kw)(
        torch.from_numpy(raw_re), torch.from_numpy(raw_im), torch.from_numpy(vel))
    want_mag, want_ok = build_jax(jcfg, **kw)(raw_re, raw_im, vel)
    assert mag.shape == (N_FRAMES, 63, 40, 1) and ok.dtype == torch.bool
    assert ok.tolist() == np.asarray(want_ok).tolist()
    assert ok.tolist()[:2] == [False, False] and int(ok.sum()) == (5 if track == "steady" else 1)
    assert_maps_close(mag, want_mag)
    assert not mag[~ok].any()


@pytest.mark.parametrize("track", ["steady", "step"])
def test_pipeline_equals_a_loop_of_the_processors_step(cfgs, recording, track):
    """The windowed batch against the port's own ring buffer, frame by frame."""
    pcfg = cfgs["ods"][0]
    raw_re, raw_im = _planes(recording)
    vel = _velocities(track)
    kw = dict(PROC_KW, num_frames=3)
    pipe = build_synthetic_aperture_pipeline(pcfg, device="cpu", **kw)
    mag, ok = pipe(torch.from_numpy(raw_re), torch.from_numpy(raw_im), torch.from_numpy(vel))
    proc = SyntheticArrayBeamformerProcessor(pcfg, device="cpu", **kw)
    state = proc.init_state()
    for t in range(N_FRAMES):
        state, (resp, valid, _) = proc.step(state, recording[t], vel[t])
        assert bool(valid) == bool(ok[t])
        if bool(valid):
            assert_maps_close(mag[t], resp.abs())


def test_pipeline_checks_its_inputs(cfgs, recording):
    pcfg = cfgs["ods"][0]
    raw_re, raw_im = (torch.from_numpy(p) for p in _planes(recording))
    pipe = build_synthetic_aperture_pipeline(pcfg, device="cpu")
    with pytest.raises(ValueError, match="velocities"):
        pipe(raw_re, raw_im, torch.zeros(N_FRAMES - 1, 3))
    with pytest.raises(TypeError):
        pipe(raw_re.double(), raw_im.double(), torch.zeros(N_FRAMES, 3))


# --------------------------------------------------------------------------- #
# golden
# --------------------------------------------------------------------------- #
def test_golden_sar_ods_through_the_port(cfgs):
    """``sar_ods.npz`` with the scenario's ``_run`` body on the port's classes."""
    sc = SCENARIOS["sar_ods"]
    with np.load(os.path.join(GOLDEN_DIR, "sar_ods.npz")) as z:
        golden = {k: z[k] for k in z.files}
    inputs = sc.make_inputs()
    assert input_sha(inputs) == str(golden.pop("meta_input_sha"))
    golden.pop("meta_generated_at", None)

    cfg = cfgs["ods"][0]
    cubes = [inputs[f"raw_{i}"] for i in range(4)]
    out = {}
    sar = StripMapSARProcessor(cfg, device="cpu")
    for vel in (0.2, 0.35):
        out[f"sar_{vel}"] = sar.process(cubes[0], vel_m_per_s=vel, sensor_height_m=0.24,
                                        max_SAR_distance=1.5).astype(np.complex64)
    out["sar_ground_range_bins"] = np.asarray(sar.ground_range_bins, np.float64)
    out["sar_ground_az_bins"] = np.asarray(sar.ground_az_bins_rad, np.float64)

    virt = VirtualArrayReformatter(cfg, device="cpu").process(cubes[0])
    dbs = RangeAngleProcessorDBSEnhanced(cfg, num_angle_bins_range_angle_response=64,
                                         num_angle_bins_dbs_enhanced_response=100,
                                         min_x_y_vel_dbs=0.25, device="cpu")
    rx = np.array([0, 3, 4, 7])
    out["dbs_slow"] = dbs.process(virt, velocity_ned=np.array([0.1, 0.05, 0.0]),
                                  rx_antennas=rx).numpy()
    out["dbs_fast"] = dbs.process(virt, velocity_ned=np.array([0.5, 0.2, 0.0]),
                                  rx_antennas=rx).numpy()

    az_bins = np.deg2rad(np.linspace(-30, 30, 40))
    sa = SyntheticArrayBeamformerProcessor(cfg, az_angle_bins_rad=az_bins,
                                           el_angle_bins_rad=EL, device="cpu", **SA_KW)
    for cube in cubes:
        sa_out = sa.process(cube.copy(), current_vel=SA_VEL)
    assert sa.array_geometry_valid
    out["sa_resp"] = np.asarray(sa_out).astype(np.complex64)
    out["sa_geometry"] = np.asarray(sa.array_geometry, np.float64)
    out["sa_pattern"] = sa.compute_synthetic_array_pattern(sa.array_geometry).astype(np.float32)

    sa_cal = SyntheticArrayBeamformerProcessor(cfg, az_angle_bins_rad=az_bins,
                                               el_angle_bins_rad=EL, enable_calibration=True,
                                               num_calibration_iters=1, device="cpu", **SA_KW)
    for cube in cubes:
        cal_out = sa_cal.process(cube.copy(), current_vel=SA_VEL)
    out["sa_cal_geometry"] = np.asarray(sa_cal.array_geometry_calibrated, np.float64)
    out["sa_cal_resp_mag"] = np.abs(np.asarray(cal_out)).astype(np.float32)
    assert set(out) == set(golden)
    sc.compare(out, golden)
