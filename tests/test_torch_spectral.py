"""The port's spectral-map family against the JAX package's, on the CPU.

Modules: ``processors.virtual_array.reformat_channels``, ``range_angle``,
``micro_doppler``, ``strip_map_sar``, ``dbs`` and the four builders of
``parallel/spectral_pipeline.py``; then the goldens ``spectral_ods`` and
``config_derived`` through the port.  Inputs are seeded simulated frames
(the JAX package's simulator, as its own tests use, or the port's
``make_inputs``), the same numpy arrays on both sides.  Bars:

- maps: rtol ``MAP_RTOL`` = 1e-4 with atol 1e-4 times the map's maximum
  (float32 FFTs and DFT matmuls summing in other orders);
- exact: channel selections, range masks, crop slices, grids, the DBS
  Doppler bins, and the batched micro-Doppler history against a loop of the
  port's own ``step`` (a gather moves the same float32 columns);
- the goldens under their scenario's own ``compare``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from golden_scenarios import (
    CONFIG_DIR, DA_COARSE_CASES, GOLDEN_DIR, SCENARIOS, STANDARD_CFG, input_sha,
)
from mmwave_radar_processing_tpu.config import load_cfg as jax_load_cfg
from mmwave_radar_processing_tpu.data import PointTarget, Scene, simulate_frames
from mmwave_radar_processing_tpu.parallel import spectral_pipeline as jsp
from mmwave_radar_processing_tpu.processors import dbs as jdbs
from mmwave_radar_processing_tpu.processors import micro_doppler as jmd
from mmwave_radar_processing_tpu.processors import range_angle as jra
from mmwave_radar_processing_tpu.processors import strip_map_sar as jsar
from mmwave_radar_processing_tpu.processors import virtual_array as jva
from mmwave_radar_processing_tpu_torch import (
    MicroDopplerProcessor,
    RangeAngleProcessor,
    RangeAngleProcessorDBSEnhanced,
    StripMapSARProcessor,
    build_dbs_pipeline,
    build_micro_doppler_pipeline,
    build_spectral_maps_pipeline,
    build_strip_map_pipeline,
    load_cfg,
    make_inputs,
)
from mmwave_radar_processing_tpu_torch.processors import dbs, micro_doppler, strip_map_sar
from mmwave_radar_processing_tpu_torch.processors.range_angle import range_angle_map
from mmwave_radar_processing_tpu_torch.processors.virtual_array import (
    reformat,
    reformat_channels,
)

torch.set_num_threads(2)  # tier-1 runs several xdist workers

MAP_RTOL = 1e-4
AZ_IDXS = (0, 3, 4, 7)
GEOMETRIES = {"ods": None, "standard": STANDARD_CFG}


def assert_maps_close(got, want):
    """``|got - want| <= MAP_RTOL*|want| + 1e-4*max|want|``, finite, same shape."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=MAP_RTOL, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def cfgs(flagship_cfg_path):
    """``{geometry: (port cfg, JAX cfg)}`` for the flagship ODS and the standard 1843 configs."""
    out = {}
    for geometry, path in GEOMETRIES.items():
        path = path or flagship_cfg_path
        out[geometry] = (load_cfg(path, array_geometry=geometry, array_direction="down"),
                         jax_load_cfg(path, array_geometry=geometry, array_direction="down"))
    return out


@pytest.fixture(scope="module")
def cubes(cfgs):
    """Four raw complex128 frames of two moving targets, and their complex64 virtual cubes."""
    jcfg = cfgs["ods"][1]
    scenes = [Scene(targets=[
        PointTarget(range_m=1.2, azimuth_rad=0.3, velocity_m_s=0.5 - 0.1 * i, rcs=2.0),
        PointTarget(range_m=0.8 + 0.05 * i, azimuth_rad=-0.2, velocity_m_s=-0.3, rcs=2.0),
    ], noise_sigma=0.05) for i in range(4)]
    raw = simulate_frames(jcfg, scenes, np.random.default_rng(5))
    virt = np.array(jva.reformat(jnp.asarray(raw.astype(np.complex64)), num_rx=4,
                                 cfgs_per_loop=3))
    return raw, virt


# --------------------------------------------------------------------------- #
# reformat_channels and range_angle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("channels", [(0,), (0, 3, 4, 7), (11, 5, 0, 6, 1), tuple(range(12))])
def test_reformat_channels_equals_jax_and_the_full_reformat(cubes, channels):
    raw = cubes[0].astype(np.complex64)
    got = reformat_channels(torch.from_numpy(raw), channels=channels, num_rx=4,
                            cfgs_per_loop=3)
    want = jva.reformat_channels(jnp.asarray(raw), channels=channels, num_rx=4,
                                 cfgs_per_loop=3)
    assert np.array_equal(got.numpy(), np.asarray(want))
    full = reformat(torch.from_numpy(raw), num_rx=4, cfgs_per_loop=3)
    assert torch.equal(got, full[..., list(channels), :, :])


@pytest.mark.parametrize("window", [True, False])
def test_range_angle_map_equals_jax(cubes, window):
    chirp = cubes[1][:2, :4, :, 0]  # [2, 4, ns]: a leading batch axis
    got = range_angle_map(torch.from_numpy(chirp), num_angle_bins=64, window=window)
    assert_maps_close(got, jra.range_angle_map(jnp.asarray(chirp), num_angle_bins=64,
                                               window=window))


@pytest.mark.parametrize("rx", [AZ_IDXS, (), None], ids=["subset", "empty", "none"])
@pytest.mark.parametrize("windowing", [True, False])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_range_angle_processor_equals_jax(cfgs, cubes, rx, windowing, geometry):
    pcfg, jcfg = cfgs[geometry]
    n_virtual = pcfg.num_rx_antennas * pcfg.chirp_cfgs_per_loop
    virt = cubes[1][0, :n_virtual, :, :pcfg.frame.loops]
    port = RangeAngleProcessor(pcfg, num_angle_bins=64, device="cpu")
    ref = jra.RangeAngleProcessor(jcfg, num_angle_bins=64)
    kw = dict(chirp_idx=1, rx_antennas=None if rx is None else list(rx),
              perform_windowing=windowing)
    got = port.process(virt, **kw)
    assert got.shape == (63, 64) and got.dtype == torch.float32
    assert_maps_close(got, ref.process(virt, **kw))
    for name in ("range_bins", "phase_shifts", "angle_bins", "thetas", "rhos", "x_s", "y_s"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name


# --------------------------------------------------------------------------- #
# micro-Doppler
# --------------------------------------------------------------------------- #
TARGET_RANGES = {"gated": (0.5, 2.0), "empty": (5.0, 6.0)}


@pytest.mark.parametrize("gate", list(TARGET_RANGES))
def test_micro_doppler_column_equals_jax(cfgs, cubes, gate):
    port = MicroDopplerProcessor(cfgs["ods"][0], target_ranges=TARGET_RANGES[gate],
                                 device="cpu")
    sl = cubes[1][:, 0]
    got = micro_doppler.micro_doppler_column(torch.from_numpy(sl),
                                             torch.from_numpy(port.range_mask))
    want = np.stack([np.asarray(jmd.micro_doppler_column(jnp.asarray(s),
                                                         jnp.asarray(port.range_mask)))
                     for s in sl])
    if gate == "empty":
        assert not port.range_mask.any()
        assert np.array_equal(got.numpy(), want) and np.isneginf(want).all()
    else:
        assert_maps_close(got, want)


@pytest.mark.parametrize("gate", list(TARGET_RANGES))
def test_micro_doppler_processor_step_scan_process_equal_jax(cfgs, cubes, gate):
    pcfg, jcfg = cfgs["ods"]
    kw = dict(target_ranges=TARGET_RANGES[gate], num_frames_history=5)
    port, ref = MicroDopplerProcessor(pcfg, device="cpu", **kw), jmd.MicroDopplerProcessor(jcfg, **kw)
    assert np.array_equal(port.range_mask, ref.range_mask)
    assert np.array_equal(port.time_bins, ref.time_bins)
    virt = cubes[1]
    for frame in virt:
        got, want = port.process(frame, rx_idx=1), ref.process(frame, rx_idx=1)
    final, stack = port.scan(virt, rx_idx=1)
    ref_final, ref_stack = ref.scan(jnp.asarray(virt), rx_idx=1)
    assert stack.shape == (4, 70, 5)
    for a, b in ((got, want), (final, ref_final), (stack, ref_stack)):
        a, b = a.numpy(), np.asarray(b)
        finite = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), finite)
        assert np.array_equal(a[~finite], b[~finite])
        if finite.any():
            np.testing.assert_allclose(a[finite], b[finite], rtol=MAP_RTOL,
                                       atol=1e-4 * np.abs(b[finite]).max())
    port.reset()
    assert torch.equal(port.micro_doppler_resp, port.init_state())


def test_micro_doppler_scan_equals_a_loop_of_step(cfgs, cubes):
    """The batched scan (columns, then one gather) against the port's own shift register."""
    port = MicroDopplerProcessor(cfgs["ods"][0], target_ranges=(0.5, 2.0),
                                 num_frames_history=3, device="cpu")
    frames = np.concatenate([cubes[1], cubes[1][::-1] * np.complex64(0.5j)])
    state, steps = port.init_state(), []
    for frame in frames:
        state, out = port.step(state, frame)
        steps.append(out)
    final, stack = port.scan(frames)
    assert torch.equal(stack, torch.stack(steps)) and torch.equal(final, state)


def test_micro_doppler_resumes_from_a_jax_state(cfgs, cubes):
    """``state_from_jax``: the port continues a recording from the JAX processor's mid-recording state."""
    pcfg, jcfg = cfgs["ods"]
    port = MicroDopplerProcessor(pcfg, target_ranges=(0.5, 2.0), num_frames_history=5,
                                 device="cpu")
    ref = jmd.MicroDopplerProcessor(jcfg, target_ranges=(0.5, 2.0), num_frames_history=5)
    virt = cubes[1]
    for frame in virt[:2]:
        ref.process(frame)
    state = port.state_from_jax(np.asarray(ref.micro_doppler_resp))
    for frame in virt[2:]:
        state, got = port.step(state, frame)
        want = ref.process(frame)
    assert_maps_close(got, want)
    with pytest.raises(ValueError, match="state shape"):
        port.state_from_jax(np.zeros((70, 4), np.float32))


# --------------------------------------------------------------------------- #
# strip-map SAR
# --------------------------------------------------------------------------- #
def test_strip_map_fft_equals_jax(cubes):
    sl = cubes[1][:, 2]
    got = strip_map_sar.strip_map_fft(torch.from_numpy(sl))
    want = np.asarray(jsar.strip_map_fft(jnp.asarray(sl)))
    assert got.dtype == torch.complex64
    assert_maps_close(got.abs(), np.abs(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("vel", [0.2, 0.35])
def test_strip_map_processor_equals_jax(cfgs, cubes, vel):
    pcfg, jcfg = cfgs["ods"]
    port, ref = StripMapSARProcessor(pcfg, device="cpu"), jsar.StripMapSARProcessor(jcfg)
    raw = cubes[0][1]
    kw = dict(vel_m_per_s=vel, sensor_height_m=0.3, rx_index=2, max_SAR_distance=2.0)
    got, want = port.process(raw, **kw), ref.process(raw, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64 and got.size > 0
    assert port.valid_ranges_slice == ref.valid_ranges_slice
    assert port.valid_angles_slice == ref.valid_angles_slice
    for name in ("angle_bins_rad", "ground_range_bins", "ground_az_bins_rad", "x_s", "y_s"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    assert_maps_close(np.abs(got), np.abs(want))


# --------------------------------------------------------------------------- #
# DBS
# --------------------------------------------------------------------------- #
def test_windowed_3d_fft_equals_jax(cubes):
    sub = cubes[1][:2, list(AZ_IDXS)]
    got = dbs.windowed_3d_fft(torch.from_numpy(sub), num_angle_bins=64)
    want = np.asarray(jdbs.windowed_3d_fft(jnp.asarray(sub), num_angle_bins=64))
    assert got.shape == (2, 64, 63, 70)
    assert_maps_close(got.abs(), np.abs(want))


VELOCITIES = [(0.5, 0.2, 0.0), (-0.4, 0.3, 0.1), (0.05, -0.9, 0.0), (0.3, 0.0, 0.2)]


@pytest.mark.parametrize("vel", VELOCITIES)
def test_dbs_sharpen_picks_the_jax_bins(cfgs, vel):
    """A map of distinct values: equal outputs mean equal (angle, Doppler) picks."""
    jcfg = cfgs["ods"][1]
    mag = np.arange(64 * 63 * 70, dtype=np.float32).reshape(64, 63, 70)
    coarse = jdbs.grids.angle_bins(64)
    dbs_bins = np.linspace(coarse[0], coarse[-1], 100)
    args = [np.asarray(vel, np.float32), dbs_bins.astype(np.float32),
            coarse.astype(np.float32), jdbs.grids.vel_bins(jcfg).astype(np.float32)]
    got = dbs.dbs_sharpen(torch.from_numpy(mag), *map(torch.from_numpy, args))
    want = np.asarray(jdbs.dbs_sharpen(jnp.asarray(mag), *map(jnp.asarray, args)))
    assert got.shape == (63, 100) and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("vel", [(0.1, 0.05, 0.0)] + VELOCITIES, ids=["slow", "fast0", "fast1",
                                                                      "fast2", "fast3"])
def test_dbs_processor_equals_jax(cfgs, cubes, vel):
    pcfg, jcfg = cfgs["ods"]
    kw = dict(num_angle_bins_range_angle_response=64,
              num_angle_bins_dbs_enhanced_response=100, min_x_y_vel_dbs=0.25)
    port = RangeAngleProcessorDBSEnhanced(pcfg, device="cpu", **kw)
    ref = jdbs.RangeAngleProcessorDBSEnhanced(jcfg, **kw)
    virt = cubes[1][2]
    got = port.process(virt, velocity_ned=np.asarray(vel), rx_antennas=list(AZ_IDXS))
    want = ref.process(virt, velocity_ned=np.asarray(vel), rx_antennas=list(AZ_IDXS))
    slow = np.hypot(*vel[:2]) < 0.25
    assert got.shape == ((63, 64) if slow else (63, 100))
    assert_maps_close(got, want)
    assert np.array_equal(port.angle_bins, ref.angle_bins)
    assert np.array_equal(port.x_s, ref.x_s)
    assert port.get_dop_vel(0.3, np.asarray(vel)) == ref.get_dop_vel(0.3, np.asarray(vel))


# --------------------------------------------------------------------------- #
# the four pipeline builders
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def planes(cfgs):
    """``make_inputs`` frames of each geometry: ``{geometry: (raw_re, raw_im)}``."""
    return {g: make_inputs(pcfg, 5, seed=7)[:2] for g, (pcfg, _) in cfgs.items()}


def _virtual_planes(cfg, raw_re, raw_im):
    return tuple(np.asarray(jva.reformat(p, num_rx=cfg.num_rx_antennas,
                                         cfgs_per_loop=cfg.chirp_cfgs_per_loop))
                 for p in (raw_re, raw_im))


DBS_VELS = np.array([[0.5, 0.2, 0.0], [0.05, 0.02, 0.0], [0.2, 0.2, 0.1], [-0.3, 0.1, 0.0],
                     [0.24, 0.01, 0.0]], np.float32)


def _run_builders(name, cfg, jcfg, raw_re, raw_im, **kw):
    """``(port output, JAX output)`` of one builder on the same planes."""
    port_in = (torch.from_numpy(raw_re), torch.from_numpy(raw_im))
    if name == "maps":
        return (build_spectral_maps_pipeline(cfg, device="cpu", **kw)(*port_in),
                jsp.build_spectral_maps_pipeline(jcfg, **kw)(raw_re, raw_im))
    if name == "micro_doppler":
        kw = dict(kw, target_ranges=(0.5, 2.0), num_frames_history=4)
        return (build_micro_doppler_pipeline(cfg, device="cpu", **kw)(*port_in),
                jsp.build_micro_doppler_pipeline(jcfg, **kw)(raw_re, raw_im))
    if name == "strip_map":
        return (build_strip_map_pipeline(cfg, device="cpu", **kw)(*port_in),
                jsp.build_strip_map_pipeline(jcfg, **kw)(raw_re, raw_im))
    return (build_dbs_pipeline(cfg, device="cpu", **kw)(*port_in, torch.from_numpy(DBS_VELS)),
            jsp.build_dbs_pipeline(jcfg, **kw)(raw_re, raw_im, DBS_VELS))


BUILDERS = ["maps", "micro_doppler", "strip_map", "dbs"]


@pytest.mark.parametrize("name", BUILDERS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_spectral_builders_equal_jax(cfgs, planes, name, geometry):
    """Each builder on raw planes, flagship ODS and standard 1843 (whose DA sub-array is windowed)."""
    pcfg, jcfg = cfgs[geometry]
    got, want = _run_builders(name, pcfg, jcfg, *planes[geometry])
    for g, w in zip(got, want) if name == "maps" else [(got, want)]:
        assert g.dtype == torch.float32
        assert_maps_close(g, w)


@pytest.mark.parametrize("name", BUILDERS)
def test_spectral_builders_take_virtual_cubes(cfgs, planes, name):
    """``reformat_input=False`` on virtual cubes equals the raw-plane run."""
    pcfg, jcfg = cfgs["ods"]
    raw = planes["ods"]
    got, want = _run_builders(name, pcfg, jcfg, *_virtual_planes(jcfg, *raw),
                              reformat_input=False)
    on_raw, _ = _run_builders(name, pcfg, jcfg, *raw)
    for g, w, r in zip(got, want, on_raw) if name == "maps" else [(got, want, on_raw)]:
        assert_maps_close(g, w)
        assert torch.equal(g, r)


def test_spectral_maps_options_equal_jax(cfgs, planes):
    pcfg, jcfg = cfgs["ods"]
    kw = dict(rx_idx=5, ra_rx_antennas=(9, 8, 5, 4), da_rx_antennas=(1, 2, 5, 6),
              num_angle_bins=32, valid_angle_range=(-0.5, 0.9), chirp_idx=3,
              da_shift_angle=False)
    got, want = _run_builders("maps", pcfg, jcfg, *planes["ods"], **kw)
    assert got.doppler_azimuth.shape == np.asarray(want.doppler_azimuth).shape
    for g, w in zip(got, want):
        assert_maps_close(g, w)


def test_micro_doppler_pipeline_equals_the_processor_loop(cfgs, planes):
    """The batched spectrogram stack against a loop of the port processor's ``step``."""
    pcfg = cfgs["ods"][0]
    raw_re, raw_im = planes["ods"]
    got = build_micro_doppler_pipeline(pcfg, rx_idx=2, target_ranges=(0.5, 2.0),
                                       num_frames_history=3, device="cpu")(
        torch.from_numpy(raw_re), torch.from_numpy(raw_im))
    port = MicroDopplerProcessor(pcfg, target_ranges=(0.5, 2.0), num_frames_history=3,
                                 device="cpu")
    virt = reformat(torch.complex(torch.from_numpy(raw_re), torch.from_numpy(raw_im)),
                    num_rx=4, cfgs_per_loop=3)
    state, steps = port.init_state(), []
    for frame in virt:
        state, out = port.step(state, frame, rx_idx=2)
        steps.append(out)
    assert_maps_close(got, torch.stack(steps))
    assert torch.equal(got[:, :, 1:][1:], got[:-1, :, :-1])  # the register shifts exactly
    assert not got[0, :, 1:].any()  # zeros before the first frame


def test_dbs_pipeline_bins_equal_jax(cfgs):
    """The per-frame Doppler bins, float32 on the device: equal to the JAX expression's."""
    pcfg, jcfg = cfgs["ods"]
    pipe = build_dbs_pipeline(pcfg, device="cpu")
    vels = np.random.default_rng(1).uniform(-1, 1, (2000, 3)).astype(np.float32)
    vel_bins = jnp.asarray(jsp.grids.vel_bins(jcfg))
    ab = jsp.grids.angle_bins(64)
    dbs_bins = np.linspace(ab[0], ab[-1], 100)
    dirs = jnp.asarray(np.stack([np.cos(dbs_bins), np.sin(dbs_bins)], axis=1), jnp.float32)
    # the expression of the JAX pipeline's frame body
    want = jax.jit(jax.vmap(lambda v: jnp.argmin(
        jnp.abs(vel_bins[None, :] - (-(dirs @ v[:2]))[:, None]), axis=1)))(vels)
    got = pipe.doppler_bins(torch.from_numpy(vels)).numpy()
    assert np.array_equal(got, np.asarray(want))
    assert len(np.unique(got)) > 30  # the picks cover many bins


@pytest.mark.parametrize("case", ["dtype", "shape", "velocities"])
def test_spectral_builders_check_their_inputs(cfgs, planes, case):
    pcfg = cfgs["ods"][0]
    raw_re, raw_im = (torch.from_numpy(p) for p in planes["ods"])
    pipe = build_dbs_pipeline(pcfg, device="cpu")
    vels = torch.from_numpy(DBS_VELS)
    if case == "dtype":
        raw_re = raw_re.double()
    elif case == "shape":
        raw_re, raw_im = raw_re[..., :70], raw_im[..., :70]
    else:
        vels = vels[:2]
    with pytest.raises((TypeError, ValueError)):
        pipe(raw_re, raw_im, vels)


# --------------------------------------------------------------------------- #
# goldens
# --------------------------------------------------------------------------- #
def _golden(name):
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _checked_inputs(name):
    """The scenario's inputs, after checking their sha against the one the golden was made from."""
    sc = SCENARIOS[name]
    golden = _golden(name)
    inputs = sc.make_inputs()
    assert input_sha(inputs) == str(golden.pop("meta_input_sha"))
    golden.pop("meta_generated_at", None)
    return sc, inputs, golden


def test_golden_spectral_ods_through_the_port(cfgs):
    """``spectral_ods.npz`` with the scenario's ``run_ours`` body on the port's classes."""
    from mmwave_radar_processing_tpu_torch.processors import (
        DopplerAzimuthProcessor, RangeDopplerProcessor, RangeProcessor,
        VirtualArrayReformatter,
    )

    sc, inputs, golden = _checked_inputs("spectral_ods")
    cfg = cfgs["ods"][0]
    virt = VirtualArrayReformatter(cfg, device="cpu").process(inputs["raw"]).numpy()
    out = {"virtual": virt.astype(np.complex64)}

    rp = RangeProcessor(cfg, device="cpu")
    coarse = np.asarray(rp.coarse_fft(virt, chirp_idx=0))
    out["range_coarse"] = coarse.astype(np.float32)
    out["range_bins"] = np.asarray(rp.range_bins, np.float64)
    zoom_mag, zoom_bins = rp.zoom_fft(virt, 0.8, 1.6, chirp_idx=0)
    out["zoom_mag"] = np.asarray(zoom_mag, np.float32)
    out["zoom_bins"] = np.asarray(zoom_bins, np.float64)
    p_rng, _, p_valid = rp.find_peaks(  # the port's peak picker takes tensors
        torch.from_numpy(20.0 * np.log10(coarse + 1e-12)),
        torch.from_numpy(np.asarray(rp.range_bins, np.float32)), max_peaks=3)
    out["range_peak_bins"] = np.sort(p_rng.numpy().astype(np.float64)[p_valid.numpy()])

    rd = RangeDopplerProcessor(cfg, device="cpu")
    out["vel_bins"] = np.asarray(rd.vel_bins, np.float64)
    out["rd_rx0_mag"] = np.asarray(rd.process(virt, rx_idx=0, return_magnitude=True),
                                   np.float32)
    out["rd_all"] = np.asarray(rd.process(virt, rx_idx=-1, return_magnitude=False),
                               np.complex64)

    ra = RangeAngleProcessor(cfg, num_angle_bins=64, device="cpu")
    out["ra_angle_bins"] = np.asarray(ra.angle_bins, np.float64)
    out["ra_subset"] = np.asarray(ra.process(virt, chirp_idx=0, rx_antennas=list(AZ_IDXS)),
                                  np.float32)
    out["ra_empty"] = np.asarray(ra.process(virt, chirp_idx=0, rx_antennas=[]), np.float32)

    da = DopplerAzimuthProcessor(cfg, num_angle_bins=64, device="cpu")
    out["da_vel_bins"] = np.asarray(da.vel_bins, np.float64)
    out["da_valid_angle_bins"] = np.asarray(da.valid_angle_bins)
    for i, (rx, window, shift) in enumerate(DA_COARSE_CASES):
        out[f"da_coarse_{i}"] = np.asarray(
            da.process(virt, rx_antennas=list(rx), range_window=list(window) if window else None,
                       shift_angle=shift), np.float32)
    precise, bins, row_valid = da.process(
        virt, rx_antennas=list(AZ_IDXS), range_window=[0.9, 2.0], shift_angle=True,
        use_precise_fft=True, precise_vel_range=[-0.25, 0.25])
    assert np.asarray(row_valid).all()
    out["da_precise"] = np.asarray(precise, np.float32)
    out["da_zoomed_vel_bins"] = np.asarray(bins, np.float64)

    md = MicroDopplerProcessor(cfg, target_ranges=[0.5, 2.0], num_frames_history=5,
                               device="cpu")
    for i in range(4):
        md_out = md.process(virt * np.exp(1j * 0.1 * i), rx_idx=0)
    out["md_final"] = np.asarray(md_out, np.float32)
    assert out["ra_empty"].shape == (63, 64)
    sc.compare(out, golden)


def test_golden_config_derived_through_the_ports_config():
    """``config_derived.npz``: the port's parser on every shipped ``.cfg`` (standard geometry)."""
    sc, inputs, golden = _checked_inputs("config_derived")
    fields = ("range_res_m", "range_bin_size_m", "range_max_m", "vel_res_m_s", "vel_max_m_s")
    out = {}
    for name in inputs:
        cfg = load_cfg(os.path.join(CONFIG_DIR, name), array_geometry="standard",
                       array_direction="down")
        out[f"{name}:derived"] = np.array([getattr(cfg, f) for f in fields], np.float64)
        out[f"{name}:ints"] = np.array(
            [cfg.num_rx_antennas, cfg.num_tx_antennas, int(cfg.virtual_antennas_enabled),
             cfg.frame.loops, cfg.frame.start_index, cfg.frame.end_index], np.int64)
    assert len(out) == len(golden) >= 2 * 4
    sc.compare(out, golden)
