"""The DBS pipeline on the benchmark's flights and against its plain reference, on the CPU.

RadVel's 20 Hz ODS configuration (``configs/6843_RadVel_ods_20Hz.cfg``) at
upstream's DBS demo settings, the benchmark's ``iwr6843ods-dbs-20hz``
(``port_bench/configs/``): the azimuth row (0, 3, 4, 7), 64 coarse angle
bins, 100 DBS bins, the gate at 0.25 m/s.

- ``build_dbs_pipeline`` equals the plain reference
  (``port_bench/reference/dbs.py``) on 8 frames, with velocities on both
  sides of the gate and one on it, of seeded random planes and of the
  benchmark's flight generator (``port_bench/gen/dbs_flight.py``): the same
  gate, the same Doppler bins, maps within ``MAP_TOL``;
- the reference's TF32 control moves the maps far past that bar;
- a lone static scatterer seen broadside to a cruise velocity peaks in the
  sharpened map within one DBS bin and one range bin of where the generator
  put it;
- the DBS traffic's check on a 16-frame copy of the cell is ``correct``
  with the program in place, and not with a planted fault or the control;
- the generator's 4096-frame velocity track falls back on 15-35% of its
  frames;
- the configuration file holds the repository's ``.cfg`` lines, and the
  reference and the generator import nothing of either package.

Bar, with its reason: ``MAP_TOL`` = 2e-6 of the frame's largest reference
value.  The program takes the three DFTs as float32 complex matrix products
(range, Doppler, angle: 63, 70 and 4 terms), the reference as FFTs: the
same sums rounded in another order, a few float32 roundings of the largest
value (measured: up to 3.8e-7).
"""

import ast
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import build_dbs_pipeline, load_cfg
from port_bench.gen import dbs_flight
from port_bench.gen.scene import generator
from port_bench.lib.harness import Cell, run_cell
from port_bench.reference import dbs as ref_dbs
from port_bench.reference.radar import parse_cfg

torch.set_num_threads(2)  # tier-1 runs several xdist workers

ROOT = Path(__file__).resolve().parents[1]
CFG_PATH = ROOT / "configs" / "6843_RadVel_ods_20Hz.cfg"
CELL = "ods20-dbs-flight-bulk"
MAP_TOL = 2e-6
BIG_SEED = 2 ** 31 + 2025
#: two frames below the gate, one on it (|v_xy| = 0.25 exactly), five above
VELOCITIES = [[0.5, 0.2, 0.0], [0.05, 0.02, 0.0], [0.25, 0.0, 0.0], [-0.3, 0.6, 0.1],
              [0.0, -0.7, 0.0], [0.1, 0.1, -0.04], [0.6, -0.3, 0.0], [-0.45, -0.45, 0.02]]


@pytest.fixture(scope="module")
def cell():
    return Cell.load(CELL)


@pytest.fixture(scope="module")
def processing(cell):
    return cell.config["processing"]


@pytest.fixture(scope="module")
def pipe(cell, processing):
    cfg = load_cfg(str(CFG_PATH), array_geometry="ods", array_direction="down")
    return build_dbs_pipeline(
        cfg, rx_antennas=tuple(processing["rx_antennas"]),
        num_angle_bins=processing["num_angle_bins"],
        num_dbs_angle_bins=processing["num_dbs_angle_bins"],
        min_x_y_vel_dbs=processing["min_x_y_vel_dbs"], chirp_idx=processing["chirp_idx"],
        device="cpu")


def random_planes(radar):
    g = torch.Generator().manual_seed(11)
    shape = (len(VELOCITIES),) + radar.frame_shape()
    return torch.randn(shape, generator=g), torch.randn(shape, generator=g)


def flight_planes(radar):
    """The generator's scatterers of 8 frames, seen at ``VELOCITIES``."""
    g = generator(BIG_SEED, "cpu")
    s = dbs_flight.scatterers(radar, len(VELOCITIES), g, "cpu")
    return dbs_flight.frames(radar, s, torch.tensor(VELOCITIES), g, "cpu")


@pytest.mark.parametrize("planes", [random_planes, flight_planes], ids=["random", "flight"])
def test_pipeline_equals_the_plain_reference(cell, processing, pipe, planes):
    re, im = planes(cell.radar)
    vels = torch.tensor(VELOCITIES)
    with torch.no_grad():
        got = pipe(re, im, vels)
        bins = pipe.doppler_bins(vels)
    ref = ref_dbs.maps(re, im, vels, cell.radar, processing, block=3)
    assert ref.fast.tolist() == [True, False, True, True, True, False, True, True]
    assert torch.equal(bins, ref.bins)
    want = ref.map()
    error = (got - want).abs().amax(dim=(1, 2)) / want.amax(dim=(1, 2))
    assert float(error.max()) <= MAP_TOL


def test_the_references_tf32_control_moves_the_maps(cell, processing):
    re, im = flight_planes(cell.radar)
    vels = torch.tensor(VELOCITIES)
    exact = ref_dbs.maps(re, im, vels, cell.radar, processing)
    rounded = ref_dbs.maps(re, im, vels, cell.radar, processing, tf32=True)
    assert torch.equal(exact.fast, rounded.fast)
    want = exact.map()
    error = (rounded.map() - want).abs().amax(dim=(1, 2)) / want.amax(dim=(1, 2))
    assert float(error.min()) > 50 * MAP_TOL


@pytest.mark.parametrize("dbs_bin, speed, sign, el_deg", [
    (27, 0.5, 1, 0.0), (40, 0.8, -1, 10.0), (50, 0.6, 1, -15.0), (61, 0.7, -1, 5.0),
    (72, 0.45, 1, 0.0)])
def test_a_lone_scatterer_peaks_where_the_generator_put_it(cell, processing, pipe, dbs_bin,
                                                           speed, sign, el_deg):
    """Broadside to the velocity its Doppler is 0, a bin's centre, and changes fastest with angle."""
    radar = cell.radar
    theta = ref_dbs.dbs_angles(processing)[0][dbs_bin]
    range_bin = 30
    vel = torch.tensor([[-sign * speed * np.sin(theta), sign * speed * np.cos(theta), 0.0]],
                       dtype=torch.float32)

    def one(v):
        return torch.tensor([[v]], dtype=torch.float64)

    s = dbs_flight.Scatterers(one(range_bin * radar.range_res), one(theta),
                              one(np.deg2rad(el_deg)), one(2.0), one(0.7))
    re, im = dbs_flight.frames(radar, s, vel, generator(BIG_SEED, "cpu"), "cpu")
    with torch.no_grad():
        out = pipe(re, im, vel)[0]
    r, d = np.unravel_index(int(out.argmax()), out.shape)
    assert abs(int(d) - dbs_bin) <= 1 and abs(int(r) - range_bin) <= 1


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_the_flight_track_falls_back_on_a_quarter_of_its_frames(cell, processing, seed):
    tr = dbs_flight.track(4096, generator(seed, "cpu"), "cpu")
    fast = ref_dbs.gate(tr.vels.to(torch.float32), processing)
    assert torch.equal(fast, tr.cruise)
    assert 0.15 <= 1.0 - float(fast.float().mean()) <= 0.35
    speed = tr.vels[:, :2].norm(dim=1)
    assert float(speed[~tr.cruise].max()) <= dbs_flight.HOVER_MAX + 1e-12


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark's folder holding ``tiny-dbs``: the cell at 16 frames, batches of 8."""
    root = tmp_path_factory.mktemp("bench") / "port_bench"
    shutil.copytree(ROOT / "port_bench", root, ignore=shutil.ignore_patterns("tests",
                                                                            "__pycache__"))
    spec = json.loads((root / "workloads" / f"{CELL}.json").read_text())
    mix = json.loads((root / "traffic" / "mixes" / f"{spec['traffic']}.json").read_text())
    mix.update(frames=16, batch=8)
    (root / "traffic" / "mixes" / "tiny-dbs.json").write_text(json.dumps(mix))
    spec.update(name="tiny-dbs", traffic="tiny-dbs", sample_frames=16)
    (root / "workloads" / "tiny-dbs.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("in_place, correct", [
    ("program", True), ("control", False), ("velocity_late", False), ("half_batch", False),
    ("unchanged", False), ("altered", False)])
def test_the_check_is_correct_with_the_program_alone(tiny_root, in_place, correct):
    result = run_cell("tiny-dbs", seed=BIG_SEED, seconds=0.01, trace=False, device="cpu",
                      t_start=time.perf_counter(), root=tiny_root,
                      fault=in_place if in_place not in ("program", "control") else None,
                      control=in_place == "control")
    assert result["correct"] is correct, result["checks"]
    assert set(result["checks"]) == {"gate_mismatch", "bin_mismatch", "map_error"}
    assert result["attempted"] >= 16 and result["attempted"] % 8 == 0
    if correct:
        assert result["metrics"]["frames_per_s"]["value"] > 0


def test_a_traced_run_on_the_cpu_reads_no_device_metric(tiny_root):
    result = run_cell("tiny-dbs", seed=3, seconds=0.01, trace=True, device="cpu",
                      t_start=time.perf_counter(), root=tiny_root)
    assert result["correct"]
    assert not any(name.startswith("dbs.") for name in result["metrics"])


def test_the_configuration_file_is_the_cfg(cell, processing):
    lines = [ln for ln in CFG_PATH.read_text().splitlines() if ln.strip() and "%" not in ln]
    assert cell.config["cfg_lines"] == lines
    assert parse_cfg(lines) == cell.radar
    assert (cell.radar.ns, cell.radar.loops, cell.radar.cpl, cell.radar.num_rx) == (63, 70, 3, 4)
    assert processing == {"rx_antennas": [0, 3, 4, 7], "num_angle_bins": 64,
                          "num_dbs_angle_bins": 100, "min_x_y_vel_dbs": 0.25, "chirp_idx": 0,
                          "reformat_input": True}
    assert cell.config["reduced"] == [] and cell.mix["kind"] == "dbs"
    assert (cell.mix["frames"], cell.mix["batch"], cell.spec["sample_frames"]) == (4096, 4096,
                                                                                   1024)


@pytest.mark.parametrize("module", ["reference/dbs.py", "gen/dbs_flight.py", "cost/dbs.py"])
def test_the_reference_and_generator_import_neither_package(module):
    tops = set()
    for node in ast.walk(ast.parse((ROOT / "port_bench" / module).read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    assert tops and not tops & {"jax", "jaxlib", "mmwave_radar_processing_tpu",
                                "mmwave_radar_processing_tpu_torch"}
