"""The port's ground scan against the JAX ``build_ground_point_cloud_pipeline`` on the CPU.

Inputs are simulated ground recordings (numpy only, the port's simulator,
bit-equal to the JAX package's): the gradual altitude profile of
``tests/test_mxu.py`` (``test_ground_pipeline_matches_object_api``), the
golden scenarios' ground cubes (``golden_scenarios._ground_cubes``), and a
recording built to reach the recursion's branches (a ground candidate that
is not the strongest peak, a frame with no eligible candidate).

Bars against JAX: the altitude track within 1e-4 m, counts and masks
identical, points within 1e-5.  The JAX ground pipeline has no ``"f32"``
mode (its modes are ``"fast"`` and ``"exact"``); its ``"exact"`` mode is the
one the point-cloud tests' ``"f32"`` runs (exact one-hot selections, angle
DFTs at the highest precision), and on the CPU ``"fast"`` is float32 as well.

Against the port's own object API (``Altimeter`` +
``RangeDopplerGroundDetector`` + ``PointCloudGenerator``): the bars of
``tests/test_mxu.py`` (points rtol 1e-3, atol 1e-4; altitude 5e-3 m).  The
plain recursion equals, bit for bit, a literal transcription of the JAX scan
body in which the zoom refinement runs only for the chosen candidate.
"""

import numpy as np
import pytest
import torch

from golden_scenarios import _ground_cubes
from mmwave_radar_processing_tpu.config import load_cfg as jax_load_cfg
from mmwave_radar_processing_tpu.parallel.ground_pipeline import (
    build_ground_point_cloud_pipeline as build_jax,
)
from mmwave_radar_processing_tpu_torch import (
    PointCloudGenerator,
    VirtualArrayReformatter,
    build_ground_point_cloud_pipeline,
    load_cfg,
)
from mmwave_radar_processing_tpu_torch.data import PointTarget, Scene, ground_scene, simulate_frame
from mmwave_radar_processing_tpu_torch.ops.altitude import (
    altitude_track_reference,
    find_ground_peak,
)
from mmwave_radar_processing_tpu_torch.processors.detection import COS_60
from mmwave_radar_processing_tpu_torch.processors.virtual_array import reformat

torch.set_num_threads(2)

ALT_ATOL, POINTS_ATOL = 1e-4, 1e-5
ALTIMETER = dict(min_altitude_m=0.25, zoom_search_region_m=0.2,
                 altitude_search_limit_m=0.4, range_bias=0.0)


@pytest.fixture(scope="module")
def cfgs(flagship_cfg_path):
    return (load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down"),
            jax_load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down"))


def _planes(raw):
    return np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32)


def _gradual(cfg, n=6, seed=3):
    """``tests/test_mxu.py``'s profile: altitude 0.55 -> 1.2 m, 0.15 m a frame."""
    rng = np.random.default_rng(seed)
    raws, alt = [], 0.4
    for _ in range(n):
        alt = min(1.2, alt + 0.15)
        scene = ground_scene(cfg, altitude_m=alt, ego_vel=(0.4, 0.1, 0.0),
                             num_patches=48, rng=rng, noise_sigma=0.03)
        raws.append(simulate_frame(cfg, scene, rng))
    return _planes(np.stack(raws))


def _branches(cfg, seed=5):
    """Frames that reach the recursion's branches from the start at 0.6 m.

    1: ground at 0.6; 2: a stronger return at 0.95 and the ground at 0.7
    (the lower, weaker candidate is the ground); 3: a return at 2.2 m only
    (no eligible candidate: the altitude holds); 4: ground at 0.85.
    """
    rng = np.random.default_rng(seed)
    frames = [[(0.6, 5.0)], [(0.95, 8.0), (0.7, 3.0)], [(2.2, 5.0)], [(0.85, 5.0)]]
    raws = [simulate_frame(cfg, Scene(targets=[PointTarget(range_m=r, rcs=a)
                                               for r, a in targets],
                                      noise_sigma=0.03), rng)
            for targets in frames]
    return _planes(np.stack(raws))


@pytest.fixture(scope="module")
def recordings(cfgs):
    cfg = cfgs[0]
    return {"gradual": _gradual(cfg), "golden": _planes(np.stack(_ground_cubes())),
            "branches": _branches(cfg)}


def _port(cfg, re, im, init=None, **kw):
    pipe = build_ground_point_cloud_pipeline(cfg, device="cpu", **kw)
    return pipe(torch.from_numpy(re), torch.from_numpy(im), init_altitude=init)


def _jax(cfg, re, im, init=None, aoa_precision="exact", **kw):
    out = build_jax(cfg, aoa_precision=aoa_precision, **kw)(re, im, init)
    return [np.asarray(a) for a in out]


def _assert_matches(got, want):
    got = [t.numpy() for t in got]
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=ALT_ATOL)  # altitude
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=ALT_ATOL)  # final
    np.testing.assert_array_equal(got[2], want[2])  # count
    np.testing.assert_array_equal(got[1], want[1])  # valid
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=POINTS_ATOL)
    assert got[2].sum() > 0


CASES = {
    "default": ("gradual", {}),
    "precise_off": ("gradual", dict(precise_est_enabled=False)),
    "range_bias": ("gradual", dict(range_bias=0.07)),
    "no_azimuth": ("gradual", dict(az_antenna_idxs=())),
    "no_elevation": ("gradual", dict(el_antenna_idxs=())),
    "golden_cubes": ("golden", dict(vel_cfar_params=dict(num_train=12, num_guard=4,
                                                         rho=0.5, alpha=8.0))),
    "branches": ("branches", dict(altitude_search_limit_m=0.4)),
    "branches_precise_off": ("branches", dict(precise_est_enabled=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ground_pipeline_matches_jax(cfgs, recordings, case):
    name, kw = CASES[case]
    re, im = recordings[name]
    init = 0.6 if name == "branches" else None
    _assert_matches(_port(cfgs[0], re, im, init, **kw), _jax(cfgs[1], re, im, init, **kw))


def test_jax_fast_mode_agrees_on_the_cpu(cfgs, recordings):
    re, im = recordings["gradual"]
    _assert_matches(_port(cfgs[0], re, im), _jax(cfgs[1], re, im, aoa_precision="fast"))


def test_branches_recording_reaches_the_branches(cfgs, recordings):
    """The scenario's self-check: a non-first ground candidate and a frame with none eligible."""
    cfg = cfgs[0]
    pipe = build_ground_point_cloud_pipeline(cfg, device="cpu", stop_after="altitude")
    re, im = (torch.from_numpy(a) for a in recordings["branches"])
    cand, valid, _, _ = pipe.altitude_inputs(re, im)
    alts, _ = pipe(re, im, init_altitude=0.6)
    assert valid[1].sum() >= 2 and float(cand[1, 0]) > float(cand[1, 1]) > 0.6
    assert abs(float(alts[1]) - 0.7) < 0.05  # the weaker, lower candidate
    assert float(alts[2]) == float(alts[1])  # nothing eligible: the altitude holds
    assert abs(float(alts[3]) - 0.85) < 0.05


def test_stop_after_altitude_matches_jax(cfgs, recordings):
    re, im = recordings["gradual"]
    alts, final = _port(cfgs[0], re, im, stop_after="altitude")
    want_alts, want_final = _jax(cfgs[1], re, im, stop_after="altitude")
    np.testing.assert_allclose(alts.numpy(), want_alts, rtol=0, atol=ALT_ATOL)
    np.testing.assert_allclose(final.numpy(), want_final, rtol=0, atol=ALT_ATOL)
    full = _port(cfgs[0], re, im)
    assert torch.equal(full.altitude, alts) and torch.equal(full.final_altitude, final)


def test_two_chunks_chained_by_final_altitude_equal_one_call(cfgs, recordings):
    cfg = cfgs[0]
    re, im = recordings["gradual"]
    whole = _port(cfg, re, im)
    first = _port(cfg, re[:3], im[:3])
    second = _port(cfg, re[3:], im[3:], init=first.final_altitude)
    for name in ("points", "valid", "count", "altitude"):
        assert torch.equal(torch.cat([getattr(first, name), getattr(second, name)]),
                           getattr(whole, name)), name
    assert torch.equal(second.final_altitude, whole.final_altitude)
    # and the JAX pipeline chained the same way
    want = _jax(cfgs[1], re[3:], im[3:], init=np.asarray(first.final_altitude))
    _assert_matches(second, want)


def test_reformat_input_false_matches_jax(cfgs, recordings):
    cfg = cfgs[0]
    re, im = recordings["gradual"]
    virt = reformat(torch.complex(torch.from_numpy(re), torch.from_numpy(im)),
                    num_rx=cfg.num_rx_antennas, cfgs_per_loop=cfg.chirp_cfgs_per_loop)
    vre, vim = virt.real.contiguous().numpy(), virt.imag.contiguous().numpy()
    got = _port(cfg, vre, vim, reformat_input=False)
    _assert_matches(got, _jax(cfgs[1], vre, vim, reformat_input=False))
    whole = _port(cfg, re, im)
    np.testing.assert_allclose(got.altitude.numpy(), whole.altitude.numpy(), atol=ALT_ATOL)
    assert torch.equal(got.count, whole.count)


def test_matches_the_ports_object_api(cfgs, recordings):
    """``tests/test_mxu.py``'s check, port against port: the frame-by-frame chain."""
    cfg = cfgs[0]
    re, im = (a[:4] for a in recordings["gradual"])  # its 4 frames
    params = dict(num_train=12, num_guard=4, rho=0.5, alpha=8.0)
    out = _port(cfg, re, im, vel_cfar_params=params)
    pcg = PointCloudGenerator(
        cfg, az_antenna_idxs=[0, 3, 4, 7], el_antenna_idxs=[9, 8, 5, 4],
        detector_type="range_doppler_ground_detector",
        detector_params=dict(vel_cfar_type="os_cfar_1d", vel_cfar_params=params,
                             altimeter_params=dict(ALTIMETER, precise_est_enabled=True)),
        device="cpu")
    var = VirtualArrayReformatter(cfg, device="cpu")
    raw = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    for i in range(len(re)):
        ref_pts = pcg.process(var.process(raw[i]))
        pts = out.points[i][out.valid[i]].numpy()
        assert pts.shape == ref_pts.shape, (i, pts.shape, ref_pts.shape)
        np.testing.assert_allclose(pts, ref_pts, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(float(out.altitude[i]),
                                   pcg.detector.altimeter.current_altitude_corrected_m,
                                   atol=5e-3)


def _transcribed_scan(pipe, re, im, init):
    """The JAX scan body, line for line: ``refine`` runs only for the chosen ``gp``."""
    gate = dict(min_altitude_m=pipe.min_altitude_m,
                altitude_search_limit_m=pipe.altitude_search_limit_m)
    chirp0 = pipe.loop0_chirps(torch.complex(re, im))
    cand, valid = pipe.peak_candidates(chirp0)
    current, alts = torch.tensor(init, dtype=torch.float32), []
    for t in range(len(re)):
        gp = find_ground_peak(cand[t], valid[t], current, **gate)
        if pipe.precise:
            if bool(gp >= 0):
                zbins, zvalid = pipe.refine_candidates(chirp0[t], gp.reshape(1))
                refined = find_ground_peak(zbins[0], zvalid[0], current, **gate)
                new = torch.where(refined > 0, refined, current)
            else:
                new = current
        else:
            new = torch.where(gp >= 0, gp, current)
        alts.append(new + pipe.range_bias)
        current = new
    return torch.stack(alts), current


@pytest.mark.parametrize("kw", [{}, dict(range_bias=0.07), dict(precise_est_enabled=False)],
                         ids=["precise", "range_bias", "precise_off"])
@pytest.mark.parametrize("name", ["gradual", "branches"])
def test_plain_recursion_equals_the_transcribed_scan(cfgs, recordings, name, kw):
    pipe = build_ground_point_cloud_pipeline(cfgs[0], device="cpu", stop_after="altitude",
                                             **kw)
    re, im = (torch.from_numpy(a) for a in recordings[name])
    init = 0.6 if name == "branches" else pipe.min_altitude_m
    alts, final = pipe(re, im, init_altitude=init)
    want_alts, want_final = _transcribed_scan(pipe, re, im, init)
    assert torch.equal(alts, want_alts)
    assert torch.equal(final, want_final)


def _numpy_track(cand, valid, zbins, zvalid, init, lo, lim, bias, precise):
    """The recursion's rule in float32 numpy, one scalar at a time."""
    f32 = np.float32
    cur, out = f32(init), []
    for t in range(len(cand)):
        ok = [valid[t, j] and cand[t, j] >= f32(lo) and abs(cand[t, j] - cur) <= f32(lim)
              for j in range(cand.shape[1])]
        gp = min([cand[t, j] for j in range(cand.shape[1]) if ok[j]], default=f32(-1))
        new = cur
        if gp >= 0:
            if precise:
                j = [j for j in range(cand.shape[1]) if ok[j] and cand[t, j] == gp][0]
                zok = [zvalid[t, j, k] and zbins[t, j, k] >= f32(lo)
                       and abs(zbins[t, j, k] - cur) <= f32(lim) for k in range(2)]
                refined = min([zbins[t, j, k] for k in range(2) if zok[k]], default=f32(-1))
                new = refined if refined > 0 else cur
            else:
                new = gp
        out.append(f32(new + f32(bias)))
        cur = new
    return np.asarray(out, np.float32), cur


@pytest.mark.parametrize("precise", [True, False])
def test_plain_recursion_on_edge_cases(precise):
    """No eligible candidate, equal candidates, ties in the refinements, a bias."""
    rng = np.random.default_rng(0)
    t = 64
    cand = np.round(rng.uniform(0.0, 2.0, (t, 3)) * 8).astype(np.float32) / 8
    cand[5] = cand[5, 0]  # three equal candidates
    cand[9] = 3.0  # nothing within the gate
    valid = rng.random((t, 3)) < 0.7
    valid[12] = False  # no valid candidate
    zbins = (cand[..., None] + np.round(rng.uniform(-0.3, 0.3, (t, 3, 2)) * 16) / 16
             ).astype(np.float32)
    zvalid = rng.random((t, 3, 2)) < 0.8
    kw = dict(lo=0.25, lim=0.4, bias=0.05, precise=precise)
    want, want_final = _numpy_track(cand, valid, zbins, zvalid, 0.9, **kw)
    got, final = altitude_track_reference(
        torch.from_numpy(cand), torch.from_numpy(valid), torch.from_numpy(zbins),
        torch.from_numpy(zvalid), torch.tensor(0.9), min_altitude_m=0.25,
        altitude_search_limit_m=0.4, range_bias=0.05, precise=precise)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(final) == float(want_final)
    assert len(np.unique(want)) > 5  # the track moves


def test_cos_60_is_the_jax_float32_value():
    import jax.numpy as jnp

    assert COS_60 == float(np.asarray(jnp.cos(jnp.deg2rad(60.0))))
    assert COS_60 != 0.5


def test_options_the_port_does_not_take_raise(cfgs):
    cfg = cfgs[0]
    with pytest.raises(ValueError, match="aoa_precision"):
        build_ground_point_cloud_pipeline(cfg, aoa_precision="fast", device="cpu")
    with pytest.raises(ValueError, match="stop_after"):
        build_ground_point_cloud_pipeline(cfg, stop_after="points", device="cpu")
    with pytest.raises(TypeError):
        build_ground_point_cloud_pipeline(cfg)  # no implicit device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_ground_point_cloud_pipeline(cfg, device="cuda")
