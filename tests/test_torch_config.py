"""The port's own copies of the host layers equal the JAX package's, bit for bit.

``config`` (parser and grids), ``data.simulator`` and ``utils.verify.make_inputs``
are numpy-only copies, so that the port imports nothing of the JAX package;
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
