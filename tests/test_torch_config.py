"""The port's own copies of the host layers equal the JAX package's, bit for bit.

``config`` (parser and grids), ``data.simulator`` and ``utils.verify``
(``make_inputs``, ``compare_outputs`` and its gates) are numpy-only copies, so that the port imports nothing of the JAX package;
here both are run on the same files and seeds and must give the same bits.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu import config as jconfig
from mmwave_radar_processing_tpu.data import simulator as jsim
from mmwave_radar_processing_tpu.utils import verify as jverify
from mmwave_radar_processing_tpu_torch import config as tconfig
from mmwave_radar_processing_tpu_torch.data import simulator as tsim
from mmwave_radar_processing_tpu_torch.utils import verify as tverify

torch.set_num_threads(2)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
CFG_FILES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIG_DIR, "*.cfg")))
GEOMETRIES = [("ods", "down"), ("standard", "forward")]


def _load(mod, name, geometry=("ods", "down")):
    return mod.load_cfg(os.path.join(CONFIG_DIR, name), array_geometry=geometry[0],
                        array_direction=geometry[1])


def test_every_shipped_config_is_covered():
    assert len(CFG_FILES) >= 20


@pytest.mark.parametrize("name", CFG_FILES)
def test_radar_config_fields_equal(name):
    for geometry in GEOMETRIES:
        ours, theirs = _load(tconfig, name, geometry), _load(jconfig, name, geometry)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("name", CFG_FILES)
def test_grids_bit_equal(name):
    ours, theirs = _load(tconfig, name), _load(jconfig, name)
    for variant in ("plain", "eps"):
        np.testing.assert_array_equal(tconfig.grids.range_bins(ours, variant=variant),
                                      jconfig.grids.range_bins(theirs, variant=variant))
    np.testing.assert_array_equal(tconfig.grids.vel_bins(ours), jconfig.grids.vel_bins(theirs))
    np.testing.assert_array_equal(tconfig.grids.time_bins(ours, 7),
                                  jconfig.grids.time_bins(theirs, 7))
    for n in (32, 64):
        np.testing.assert_array_equal(tconfig.grids.phase_shift_bins(n),
                                      jconfig.grids.phase_shift_bins(n))
        np.testing.assert_array_equal(tconfig.grids.angle_bins(n), jconfig.grids.angle_bins(n))
    mesh_a = tconfig.grids.polar_mesh(tconfig.grids.range_bins(ours), tconfig.grids.angle_bins(64))
    mesh_b = jconfig.grids.polar_mesh(jconfig.grids.range_bins(theirs), jconfig.grids.angle_bins(64))
    for a, b in zip(mesh_a, mesh_b):
        np.testing.assert_array_equal(a, b)


def test_grids_take_a_config_of_either_package():
    ours, theirs = (_load(m, "6843_RadVel_ods_20Hz.cfg") for m in (tconfig, jconfig))
    np.testing.assert_array_equal(tconfig.grids.range_bins(theirs), jconfig.grids.range_bins(ours))


@pytest.mark.parametrize("name,geometry", [("6843_RadVel_ods_20Hz.cfg", ("ods", "down")),
                                           ("1843_RadVel_20Hz.cfg", ("standard", "forward"))])
def test_simulate_frame_bit_equal(name, geometry):
    ours, theirs = _load(tconfig, name, geometry), _load(jconfig, name, geometry)

    def frame(sim, cfg):
        scene = sim.Scene(targets=[
            sim.PointTarget(range_m=1.5, azimuth_rad=0.2, velocity_m_s=0.7, rcs=3.0),
            sim.PointTarget(range_m=2.5, azimuth_rad=-0.4, elevation_rad=0.1, rcs=2.0),
        ], noise_sigma=0.05)
        return sim.simulate_frame(cfg, scene, np.random.default_rng(5))

    a, b = frame(tsim, ours), frame(jsim, theirs)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    # the port's simulator takes the JAX package's config too, and the other way round
    np.testing.assert_array_equal(frame(tsim, theirs), frame(jsim, ours))


def test_ground_scene_and_geometries_equal():
    ours, theirs = (_load(m, "6843_RadVel_ods_20Hz.cfg") for m in (tconfig, jconfig))
    a = tsim.ground_scene(ours, altitude_m=1.1, ego_vel=(0.3, 0.1, 0.0), num_patches=16,
                          rng=np.random.default_rng(2))
    b = jsim.ground_scene(theirs, altitude_m=1.1, ego_vel=(0.3, 0.1, 0.0), num_patches=16,
                          rng=np.random.default_rng(2))
    assert [dataclasses.asdict(t) for t in a.targets] == [dataclasses.asdict(t) for t in b.targets]
    for name in ("standard_geometry", "ods_geometry"):
        ga, gb = (dataclasses.asdict(getattr(sim, name)()) for sim in (tsim, jsim))
        assert ga.keys() == gb.keys()
        for key in ga:
            np.testing.assert_array_equal(ga[key], gb[key])


@pytest.mark.parametrize("seed", [7, 11])
def test_make_inputs_bit_equal(seed):
    ours, theirs = (_load(m, "6843_RadVel_ods_20Hz.cfg") for m in (tconfig, jconfig))
    for a, b in zip(tverify.make_inputs(ours, 3, seed=seed),
                    jverify.make_inputs(theirs, 3, seed=seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _point_cloud_leaves(seed, frames=6, capacity=16, flips=0, empty_frame=False):
    """Seeded ``pointcloud_f32`` leaves; ``flips`` detections dropped from some frames."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0 if empty_frame else 3, capacity + 1, frames).astype(np.int32)
    if empty_frame:
        count[0] = 0
    valid = np.arange(capacity)[None, :] < count[:, None]
    points = rng.normal(0, 2, (frames, capacity, 4)).astype(np.float32) * valid[..., None]
    other = {"points": points.copy(), "valid": valid.copy(), "count": count.copy()}
    for f in range(min(flips, frames)):
        if count[f] > 1:  # drop the first detection: every later slot shifts
            n = count[f] - 1
            other["points"][f, :n] = points[f, 1 : n + 1]
            other["points"][f, n:] = 0
            other["valid"][f, n] = False
            other["count"][f] = n
    other["points"] += rng.normal(0, 1e-4, other["points"].shape).astype(np.float32) \
        * other["valid"][..., None]
    name = lambda d: {f"pointcloud_f32/{k}": v for k, v in d.items()}  # noqa: E731
    return name(dict(points=points, valid=valid, count=count)), name(other)


@pytest.mark.parametrize("case", [dict(seed=0), dict(seed=1, flips=2), dict(seed=2, flips=6),
                                  dict(seed=3, empty_frame=True), dict(seed=4, frames=1)],
                         ids=["agree", "two_flips", "every_frame_flips", "empty_frame",
                              "one_frame"])
def test_compare_outputs_equals_the_jax_packages(case):
    """Same report, key for key, gates included; exact equality (the copy is numpy only)."""
    oracle, device = _point_cloud_leaves(**case)
    extra = np.random.default_rng(9)
    for name, leaf in (("velocity/vx", extra.normal(0, 1, 8).astype(np.float32)),
                       ("velocity/bins", extra.integers(0, 60, (8, 5)).astype(np.int32)),
                       ("capon/out", extra.normal(50, 9, (2, 5, 7)).astype(np.float32))):
        oracle[name] = leaf
        device[name] = leaf + (leaf.dtype == np.float32) * np.float32(0.015)
    device["velocity/bins"] = device["velocity/bins"].copy()
    device["velocity/bins"][0, 0] += 1
    del device["capon/out"]  # a leaf missing on one side
    ours = tverify.compare_outputs(oracle, device)
    theirs = jverify.compare_outputs(oracle, device)
    assert ours == theirs
    assert {leaf["leaf"] for leaf in ours["leaves"]} == set(oracle)
    points = next(l for l in ours["leaves"] if l["leaf"] == "pointcloud_f32/points")
    assert points["gate"] == 0.95 == jverify.METRIC_POINTS_IOU["pointcloud_f32"]


def test_compare_outputs_gates_are_the_jax_packages():
    for name in ("MIN_DISCRETE_AGREEMENT", "FLOAT_ATOL", "FLOAT_RTOL", "MIN_POINTS_IOU",
                 "MIN_COUNT_NEAR", "METRIC_POINTS_IOU", "METRIC_COUNT_NEAR"):
        assert getattr(tverify, name) == getattr(jverify, name), name


def test_point_set_report_equals_the_jax_packages():
    oracle, device = _point_cloud_leaves(seed=5, flips=3)
    args = (oracle["pointcloud_f32/points"], oracle["pointcloud_f32/valid"],
            device["pointcloud_f32/points"], device["pointcloud_f32/valid"])
    ours = tverify._point_set_report(*args, tol=1e-2)
    assert ours == jverify._point_set_report(*args, tol=1e-2)
    assert 0.5 < ours["set_iou_mean"] < 1.0  # the flips are seen, the rest matches
