"""The port's viewer pipelines against the JAX package's, on the CPU.

``parallel/viewer_pipeline.py``'s three build functions (the payload pipeline, the
ground detector's gated tail and the DBS stage) on the same seeded planes
(``make_inputs``, numpy only) in both packages; JAX runs on the CPU on its
own path.  Two configs: the flagship ODS config and the 1843
standard-geometry config (8 virtual channels, 100 loops, the angle window
of the Doppler-azimuth map).  Bars: maps within rtol 1e-5 and 1e-5 of the
maximum; indices, validity and counts identical; points within 1e-5;
thresholds with identical finite masks and rtol 1e-5 where finite.
"""

import os

import numpy as np
import pytest
import torch

import jax
from mmwave_radar_processing_tpu.config import grids as jax_grids
from mmwave_radar_processing_tpu.config import load_cfg as jax_load_cfg
from mmwave_radar_processing_tpu.parallel import viewer_pipeline as jvp
from mmwave_radar_processing_tpu_torch import load_cfg, make_inputs
from mmwave_radar_processing_tpu_torch.config import grids
from mmwave_radar_processing_tpu_torch.parallel import (
    build_dbs_viewer_stage,
    build_ground_detector_stage,
    build_viewer_payload_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.viewer_pipeline import GROUPS

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
FLAGSHIP = ("6843_RadVel_ods_20Hz.cfg", "ods")
STANDARD = ("1843_RadVel_20Hz.cfg", "standard")
OS_PARAMS = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
RTOL = 1e-5
ATOL_OF_MAX = 1e-5
POINTS_ATOL = 1e-5
BATCH = 5

#: per config: keywords that fit its array (the standard geometry has 8
#: virtual channels), an empty subset and a non-zero rx_idx among them
CASES = {
    "flagship": (FLAGSHIP, dict()),
    "flagship_no_az": (FLAGSHIP, dict(az_antenna_idxs=(), rx_idx=5,
                                      da_rx_antennas=(0, 3, 4, 7),
                                      ra_rx_antennas=(1, 2, 5, 6))),
    "standard": (STANDARD, dict(az_antenna_idxs=tuple(range(8)), el_antenna_idxs=(),
                                rx_idx=3, valid_angle_range=(-0.5, 0.7),
                                md_target_ranges=(0.3, 2.5))),
}


@pytest.fixture(scope="module", params=[FLAGSHIP, STANDARD], ids=["flagship", "standard"])
def planes(request):
    name, geometry = request.param
    path = os.path.join(CONFIGS, name)
    cfg = load_cfg(path, array_geometry=geometry, array_direction="down")
    jcfg = jax_load_cfg(path, array_geometry=geometry, array_direction="down")
    re, im, _ = make_inputs(cfg, BATCH, seed=7)
    return cfg, jcfg, re, im


def _configs(case):
    (name, geometry), kw = CASES[case]
    path = os.path.join(CONFIGS, name)
    return (load_cfg(path, array_geometry=geometry, array_direction="down"),
            jax_load_cfg(path, array_geometry=geometry, array_direction="down"), dict(kw))


def assert_leaf(name, got, want):
    """One leaf of the port against JAX's: dtype and shape, then the leaf's bar."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype != np.float32:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=name)
    if not finite.any():
        return
    if name == "points":
        np.testing.assert_allclose(got, want, rtol=0, atol=POINTS_ATOL, err_msg=name)
        return
    scale = float(np.max(np.abs(want[finite])))
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL,
                               atol=ATOL_OF_MAX * scale, err_msg=name)


def run_both(cfg, jcfg, re, im, **kw):
    want = jvp.build_viewer_payload_pipeline(jcfg, **kw)(re, im)
    got = build_viewer_payload_pipeline(cfg, device="cpu", **kw)(
        torch.from_numpy(re), torch.from_numpy(im))
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("cfar_type", ["os_cfar_2d", "ca_cfar_2d"])
@pytest.mark.parametrize("case", list(CASES))
def test_payload_pipeline_equals_jax(case, cfar_type):
    cfg, jcfg, kw = _configs(case)
    re, im, _ = make_inputs(cfg, BATCH, seed=7)
    kw.update(include=sorted(GROUPS), cfar_type=cfar_type,
              cfar_params=OS_PARAMS if cfar_type == "os_cfar_2d" else None)
    got, want = run_both(cfg, jcfg, re, im, **kw)
    assert set(got) == set(want)
    for name in sorted(want):
        assert_leaf(name, got[name], want[name])
    assert int(want["det_count"].sum()) > 0 and int(want["detseq_count"].sum()) > 0
    assert bool(want["det1d_valid"].any())


@pytest.mark.parametrize("include", [None, [], ["md"], ["da"], ["ra"], ["det1d"], ["detseq"],
                                     ["det2d"]], ids=lambda g: "default" if g is None
                         else "+".join(g) or "maps_only")
def test_include_groups_give_the_jax_leaves(planes, include):
    cfg, jcfg, re, im = planes
    kw = dict(include=include)
    if cfg.array_geometry == "standard":
        kw.update(az_antenna_idxs=(0, 1, 2, 3), el_antenna_idxs=())
    got, want = run_both(cfg, jcfg, re, im, **kw)
    assert set(got) == set(want)
    for name in sorted(want):
        assert_leaf(name, got[name], want[name])


def test_custom_cfars_equal_jax(planes):
    """Other 1D kinds for the range and sequential detectors, a custom OS window in 2D."""
    cfg, jcfg, re, im = planes
    kw = dict(include=["det1d", "detseq", "det2d"], cfar_type="os_cfar_2d",
              cfar_params=dict(num_train=(4, 6), num_guard=(2, 1), rho=0.5, alpha=3.0),
              cfar1d_type="ca_cfar_1d", cfar1d_params=dict(num_train=4, num_guard=2, pfa=0.05),
              max_dets_1d=8, max_dets=16,
              seq_rng_cfar=("go_cfar_1d", dict(num_train=4, num_guard=2, pfa=0.1)),
              seq_vel_cfar=("so_cfar_1d", dict(num_train=6, num_guard=1, pfa=0.1)))
    if cfg.array_geometry == "standard":
        kw.update(az_antenna_idxs=(0, 1, 2, 3), el_antenna_idxs=(4, 5, 6, 7))
    got, want = run_both(cfg, jcfg, re, im, **kw)
    for name in sorted(want):
        assert_leaf(name, got[name], want[name])


def test_payload_pipeline_rejects_what_it_does_not_implement(planes):
    cfg, _, re, im = planes
    with pytest.raises(ValueError, match="2D CFAR"):
        build_viewer_payload_pipeline(cfg, cfar_type="go_cfar_2d", device="cpu")
    with pytest.raises(ValueError, match="groups"):
        build_viewer_payload_pipeline(cfg, include=["md", "velocity"], device="cpu")
    pipe = build_viewer_payload_pipeline(cfg, include=[], device="cpu")
    with pytest.raises(ValueError, match="planes"):
        pipe(torch.from_numpy(re[:, :, :-1]), torch.from_numpy(im[:, :, :-1]))
    with pytest.raises(TypeError):
        build_viewer_payload_pipeline(cfg)  # no implicit default device


def altitudes(cfg):
    """Altitudes on range bins, between them, and past the gate's far end."""
    bins = grids.range_bins(cfg, variant="eps").astype(np.float32)
    on = bins[[3, 10, 25]]
    between = (bins[[4, 12, 30]] + bins[[5, 13, 31]]) / 2
    far = np.float32([bins[-1] * 0.6, bins[-1] + 1.0])
    return np.concatenate([on, between, far]).astype(np.float32)


@pytest.mark.parametrize("vel_cfar", [None, ("os_cfar_1d", dict(num_train=5, num_guard=2,
                                                                 rho=0.6, alpha=4)),
                                      ("ca_cfar_1d", dict(num_train=6, num_guard=2, pfa=0.05))],
                         ids=["default", "os", "ca"])
def test_ground_detector_stage_equals_jax(planes, vel_cfar):
    cfg, jcfg, re, im = planes
    alt = altitudes(cfg)
    rd = build_viewer_payload_pipeline(cfg, include=[], device="cpu")(
        torch.from_numpy(re), torch.from_numpy(im))["rd_map"]
    rd = rd.repeat((len(alt) + BATCH - 1) // BATCH, 1, 1)[:len(alt)]
    kw = {} if vel_cfar is None else dict(vel_cfar_type=vel_cfar[0],
                                          vel_cfar_params=vel_cfar[1])
    want = jvp.build_ground_detector_stage(jcfg, **kw)(rd.numpy(), alt)
    got = build_ground_detector_stage(cfg, device="cpu", **kw)(rd, torch.from_numpy(alt))
    for name, g, w in zip(("det_r", "det_v", "det_valid", "det_count"), got, want):
        assert_leaf(name, g, w)
    assert int(np.asarray(want[3]).sum()) > 0


def test_ground_gate_equals_jax_at_bin_boundaries(planes):
    """The gate rows at altitudes spread finely over the bins, edges included."""
    cfg, jcfg, _, _ = planes
    bins = grids.range_bins(cfg, variant="eps").astype(np.float32)
    np.testing.assert_array_equal(bins, jax_grids.range_bins(jcfg, variant="eps")
                                  .astype(np.float32))
    alt = np.linspace(bins[0] - 0.1, bins[-1] * 0.7, 997).astype(np.float32)
    alt = np.concatenate([alt, bins, (bins[1:] + bins[:-1]) / 2]).astype(np.float32)
    stage = build_ground_detector_stage(cfg, device="cpu")
    got = stage.range_gate(torch.from_numpy(alt)).numpy()
    # the JAX stage's gate: a map that every cell detects leaves the gate alone
    ones = np.zeros((len(alt), len(bins), cfg.frame.loops), np.float32)
    j = jvp.build_ground_detector_stage(
        jcfg, vel_cfar_type="ca_cfar_1d",
        vel_cfar_params=dict(num_train=1, num_guard=0, pfa=0.5), max_dets=len(bins))
    ones[..., 1] = 1.0  # the column whose neighbours are zero: a detection on every row
    r, _, valid, _ = (np.asarray(x) for x in j(ones, alt))
    want = np.zeros_like(got)
    for i in range(len(alt)):
        want[i, r[i][valid[i]]] = True
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("a_dbs,rx", [(100, (0, 3, 4, 7)), (64, None)], ids=["100_sub", "64_all"])
def test_dbs_stage_equals_jax_on_both_branches(planes, a_dbs, rx):
    cfg, jcfg, re, im = planes
    if rx is not None and cfg.num_virtual_antennas < 8:
        pytest.skip("subset beyond the array")
    rng = np.random.default_rng(11)
    speed = np.array([0.1, 0.5, 0.05, 0.8, 0.3])
    heading = rng.uniform(-np.pi, np.pi, BATCH)
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading),
                    rng.normal(0, 0.05, BATCH)], axis=1).astype(np.float32)
    kw = dict(num_angle_bins_dbs_enhanced_response=a_dbs, rx_antennas=rx)
    want = jvp.build_dbs_viewer_stage(jcfg, **kw)(re, im, vel)
    got = build_dbs_viewer_stage(cfg, device="cpu", **kw)(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(vel))
    for name, g, w in zip(("ra_map", "dbs_map", "use_dbs"), got, want):
        assert_leaf(name, g, w)
    use = np.asarray(want[2])
    assert use.any() and not use.all()


def test_dbs_stage_checks_its_velocities(planes):
    cfg, _, re, im = planes
    stage = build_dbs_viewer_stage(cfg, device="cpu")
    with pytest.raises(ValueError, match="velocities"):
        stage(torch.from_numpy(re), torch.from_numpy(im), torch.zeros(BATCH, 2))


def test_jax_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
