"""The velocity-analysis cell's pieces: its files, the flight generator, the reference, the cost, the readers, the faults.

CPU only.  The generator's tracks are drawn whole (4096 frames); the
reference tracks a few hundred frames of a flight; the runs are of the tiny
copy of the cell (``conftest.bench_copy``), whose mix is cut to 16 frames in
batches of 8 chained through both carries.
"""

import json
import math
import time

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR, CHECKOUT
from port_bench.cost import roofline
from port_bench.cost.ground import ground_call, transform
from port_bench.gen import ground_flight, scene
from port_bench.lib import stages as st
from port_bench.lib.harness import Cell, metric_modules, run_cell
from port_bench.reference import ground as ref_ground
from port_bench.traffic import groundvel

CELL = "ods20-groundvel-flight-bulk"
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
BIG_SEED = 2 ** 31 + 6061
LIMITS = {"altitude_mismatch", "det_mismatch", "angle_mismatch", "velocity_mismatch",
          "overflow"}
STAGES = ("range", "zoom", "track", "detect", "aoa", "vel")
STAGE_METRICS = {f"gnd.{s}.ms_per_kframe": f"mmw.gnd.{s}" for s in STAGES}


@pytest.fixture(scope="module")
def cell():
    return Cell.load(CELL)


@pytest.fixture(scope="module")
def settings(cell):
    return ref_ground.settings(cell.config["processing"])


def test_the_cell_its_configuration_and_its_mix(cell, settings):
    lines = [ln for ln in (CHECKOUT / "configs" / "6843_RadVel_ods_20Hz.cfg").read_text()
             .splitlines() if ln.strip() and "%" not in ln]
    assert cell.config["cfg_lines"] == lines and cell.config["reduced"] == []
    assert cell.mix == dict(cell.mix, kind="groundvel", frames=4096, batch=4096)
    assert set(cell.spec["limits"]) == LIMITS and cell.spec["limits"]["overflow"] == 0
    assert settings == dict(
        az_antennas=[0, 3, 4, 7], el_antennas=[9, 8, 5, 4], az_shift=True, el_shift=False,
        vel_cfar=dict(num_train=5, num_guard=2, rho=0.6, alpha=4), min_altitude_m=0.25,
        zoom_search_region_m=0.2, altitude_search_limit_m=0.4, range_bias=0.0,
        precise_est_enabled=True, min_r2=0.2, min_inlier_fraction=0.5, max_dets=512,
        num_angle_bins=64, ransac_min_samples=10, ransac_residual_threshold=0.15,
        ransac_max_trials=20)


def test_every_reader_of_the_kind_is_listed_for_the_cell():
    listed = {m["name"]: m for m in BENCH["per_layer"] if CELL in m.get("workloads", [])}
    kind = {name for name, m in metric_modules().items() if "groundvel" in m.KINDS}
    assert set(listed) == kind == {*STAGE_METRICS, "gnd.launches_per_kframe",
                                   "gnd.roofline_pct"}
    for name, module in metric_modules().items():
        if name in kind:
            assert module.KINDS == ("groundvel",) and listed[name]["workloads"] == [CELL]
            assert listed[name]["layer"] == module.LAYER


def test_same_seed_same_flight_other_seed_other_flight(cell):
    a = ground_flight.flight(cell.radar, 6, BIG_SEED, "cpu")
    b = ground_flight.flight(cell.radar, 6, BIG_SEED, "cpu")
    c = ground_flight.flight(cell.radar, 6, BIG_SEED + 1, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.re, c.re) and not torch.equal(a.altitude, c.altitude)
    assert a.re.shape == (6, 4, 63, 210) and a.re.dtype == torch.float32
    # the track is drawn first: a shorter flight is the longer one's start
    short = ground_flight.flight(cell.radar, 3, BIG_SEED, "cpu")
    assert torch.equal(short.altitude, a.altitude[:3])
    s = ground_flight.scores(5, 20, 512, BIG_SEED, "cpu")
    assert s.shape == (5, 20, 512) and torch.equal(s, ground_flight.scores(5, 20, 512, BIG_SEED,
                                                                          "cpu"))
    assert not torch.equal(s, scene.gumbel((5, 20, 512), BIG_SEED, "cpu"))


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_the_true_altitude_stays_inside_the_ground_gate(cell, settings, seed):
    tr = ground_flight.track(4096, scene.generator(seed, "cpu"), "cpu")
    h = tr.altitude
    last_bin = float(cell.radar.range_bins().max())
    assert float(h.min()) >= ground_flight.TAKEOFF_M[0] > settings["min_altitude_m"]
    assert float(h.max()) <= ground_flight.HOLD_M[1]
    assert float(h.max()) / math.cos(math.radians(60)) < last_bin  # [h, 2h] inside the range
    step = h.diff().abs()
    assert float(step.max()) <= ground_flight.RATE_M_S[1] * ground_flight.DT + 1e-12
    # the boresight speed is the altitude's rate; holds do not move the ground
    assert torch.allclose(-tr.vels[1:, 0] * ground_flight.DT, h.diff(), atol=1e-9)
    assert not tr.vels[tr.hold, 0].any()
    assert 0.6 <= float(tr.hold.float().mean()) <= 0.95
    horizontal = tr.vels[:, 1:].norm(dim=1)
    assert float(horizontal.max()) <= 0.8 * math.sqrt(2) + 0.2


@pytest.mark.parametrize("seed", [7, BIG_SEED])
def test_the_reference_tracks_the_true_altitude(cell, settings, seed):
    """Within 2 range bins on 93% of frames and 4 on 98.5%: upstream's zoom rule misses single frames.

    Where the ground patches keep the zoom band's far edge high, the band's
    main peak falls under the 6 dB prominence, and the lowest prominent peak
    left is the Hann window's sidelobe about 0.15 m below the ground; the
    tracker comes back the next frame.  Measured over 512-frame flights of
    four seeds: 95.3-96.9% within 2 bins, 98.6-100% within 4; the JAX
    package's ``build_ground_point_cloud_pipeline``, a second witness run on
    the CPU over the same flights, tracks the same altitude to 1 mm on every
    one of their 2048 frames.
    """
    f = ground_flight.flight(cell.radar, 384, seed, "cpu")
    alt, final = ref_ground.altitudes(f.re, f.im, cell.radar, settings)
    err = (alt - f.altitude).abs()
    res = cell.radar.range_res
    assert float((err <= 2 * res).float().mean()) >= 0.93
    assert float((err <= 4 * res).float().mean()) >= 0.985
    assert float(err.median()) <= res / 2
    assert final == pytest.approx(float(alt[-1]))


def test_the_reference_zoom_is_the_dtft_of_the_band(cell):
    """A lone return at a known range peaks in the zoom within one zoom step."""
    radar = cell.radar

    def one(v):
        return torch.tensor([[v]], dtype=torch.float64)

    target = 1.2345
    re, im = ground_flight.frames(radar, (one(target), one(0.0), one(0.0), one(0.0), one(3.0),
                                          one(0.4)), scene.generator(1, "cpu"), "cpu")
    chirps = ref_ground.loop0_chirps(re, im, radar)[0]
    lo, hi = np.float32(target - 0.2), np.float32(target + 0.2)
    ranges, ok = ref_ground.zoom_peaks(chirps, lo, hi, radar, tf32=False)
    assert ok[0] and abs(float(ranges[0]) - target) <= float(hi - lo) / (radar.ns - 1)


def test_the_cost_of_a_call():
    """Transforms at the lesser of a direct sum and an FFT; one zoom a frame; byte-bound at these shapes."""
    ops, nbytes = ground_call(2, ns=63, loops=70, rx=4, cpl=3, union=7, az_antennas=4,
                              el_antennas=4, angle_bins=64, capacity=512, num_train=5,
                              num_guard=2, trials=20, samples=10, dims=3,
                              dets_per_frame=100.0, gated_rows_per_frame=20.0)
    fft = lambda n: 5 * n * math.log2(n)  # noqa: E731
    per_frame = (2 * 12 * fft(63) + 70 * 7 * fft(63) + 63 * fft(70) + 3 * 10 * 56 * 20
                 + 100 * (7 * 8 * 70 + 2 * fft(64)) + 20 * (24 * 10 + 6 * 100) + 24 * 100)
    assert ops == pytest.approx(2 * per_frame, rel=1e-12)
    assert transform(4, 64, 64) == fft(64) < 8 * 4 * 64  # an FFT beats the direct sum
    assert transform(70, 1, 70) == 8 * 70  # one output: the direct sum is less
    assert nbytes == 2 * (8 * 4 * 63 * 210 + 4 * 20 * 512 + 17 * 512 + 40)
    assert roofline.bound_seconds(ops, nbytes) == nbytes / roofline.PEAK_HBM_BYTES_S


def _stages(frames=4096):
    """Hand-built stages: one call of ``mmw.gnd`` with its six stages nested, and an outside copy."""
    spans = [("mmw.gnd", 0, 100)] + [(f"mmw.gnd.{s}", 10 * i, 10) for i, s in enumerate(STAGES)]
    events = [{"cat": "user_annotation", "name": n, "ts": ts, "dur": dur, "tid": 1}
              for n, ts, dur in spans]
    launches = {i + 1: 10 * i + 5 for i in range(len(STAGES))}
    launches[7] = 150
    for corr, ts in launches.items():
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                       "tid": 1, "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": f"k{corr}", "ts": 1000, "dur": 100 * corr,
                       "tid": 7, "args": {"correlation": corr}})
    return st.Stages.from_events(events, frames=frames)


def test_the_readers_read_the_stages(cell, settings):
    stages, modules = _stages(), metric_modules()
    values = {"dets_per_frame": 120.0, "gated_rows_per_frame": 18.0}
    ctx = {"cell": cell, "stages": stages, "values": values}
    for i, (name, span) in enumerate(STAGE_METRICS.items()):
        assert modules[name].read(ctx) == pytest.approx(100 * (i + 1) / 1e6 * 1e3 * 1024 / 4096)
        assert stages.stage_seconds(span) > 0
    assert modules["gnd.launches_per_kframe"].read(ctx) == 6 * 1024 / 4096
    bound = roofline.bound_seconds(*ground_call(
        4096, ns=63, loops=70, rx=4, cpl=3, union=7, az_antennas=4, el_antennas=4,
        angle_bins=64, capacity=512, num_train=5, num_guard=2, trials=20, samples=10, dims=3,
        **values))
    inside = 100 * (1 + 2 + 3 + 4 + 5 + 6) / 1e6  # the copy at 150 is outside mmw.gnd
    assert modules["gnd.roofline_pct"].read(ctx) == pytest.approx(100 * bound / inside)
    bare = {"cell": cell, "stages": st.Stages(frames=4096), "values": values}
    for name in [*STAGE_METRICS, "gnd.launches_per_kframe", "gnd.roofline_pct"]:
        assert modules[name].read(bare) is None, name
    assert modules["gnd.roofline_pct"].read(dict(ctx, values={})) is None


def _run(root, **kw):
    return run_cell(f"tiny-{CELL}", seed=BIG_SEED, seconds=0.05, trace=False, device="cpu",
                    t_start=time.perf_counter(), root=root, **kw)


def test_the_tiny_cell_is_correct(bench_copy):
    result = _run(bench_copy)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == LIMITS
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(c["value"] == 0 for c in result["checks"].values())


def test_the_control_fails_on_the_clouds_and_the_velocity(bench_copy):
    checks = _run(bench_copy, control=True)["checks"]
    for number in ("det_mismatch", "velocity_mismatch"):
        assert checks[number]["value"] > checks[number]["limit"], number
    assert checks["overflow"]["value"] == 0


@pytest.mark.parametrize("fault,numbers", [
    ("altitude_late", {"altitude_mismatch"}),
    ("velocity_late", {"velocity_mismatch"}),
    ("altered", {"det_mismatch"}),
    ("half_batch", {"altitude_mismatch", "det_mismatch", "velocity_mismatch"}),
    ("unchanged", {"altitude_mismatch", "det_mismatch", "velocity_mismatch"})])
def test_each_planted_fault_fails_where_it_should(bench_copy, fault, numbers):
    checks = _run(bench_copy, fault=fault)["checks"]
    failed = {name for name, c in checks.items() if c["value"] > c["limit"]}
    assert failed == numbers, checks


def test_an_unknown_fault_is_refused(bench_copy):
    with pytest.raises(ValueError, match="unknown fault"):
        _run(bench_copy, fault="no_such_fault")


def test_the_numbers_of_outputs_against_the_reference(cell):
    radar = cell.radar
    pts = torch.zeros((2, 3, 4))
    pts[:, 0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    valid = torch.tensor([[True, False, False], [True, False, False]])
    ref = ref_ground.Analysis(
        altitude=torch.tensor([1.0, 1.2, 1.4]), points=torch.cat([pts, pts[:1]]),
        valid=torch.cat([valid, valid[:1]]), count=torch.tensor([1, 600, 1]),
        proposed=torch.zeros((3, 3)), r2=torch.tensor([0.5, 0.5, 0.5]),
        inlier_fraction=torch.tensor([0.6, 0.6, 0.6]), velocity=torch.zeros((3, 3)),
        kappa=torch.full((3,), 5.0), source=torch.tensor([0, 1, 2]))
    out = {"points": pts.numpy(), "valid": valid.numpy(),
           "velocity": np.array([[0, 0, 0], [0, 0.002, 0]], np.float32),
           "fit": np.array([[0.5, 0.6], [0.5, 0.6]], np.float32)}
    # the altitude of every frame is compared, the other numbers on the sampled frames 0 and 2
    altitude = np.array([1.0, 1.2015, 1.4005], np.float32)
    nums = groundvel.ground_numbers(altitude, out, ref, np.array([0, 2]), radar, max_dets=512)
    assert nums == {"altitude_mismatch": 1 / 3, "det_mismatch": 0.0, "angle_mismatch": 0.0,
                    "velocity_mismatch": 0.5, "overflow": 1.0}


def test_a_carried_estimate_known_only_to_float32_rounding_is_held_to_that(cell):
    """Frame 2 carries frame 1's fit, whose inlier directions have a condition number of 1000.

    A float32 solve may err by 2^-24 * 1000^2 * 2 m/s = 0.12 m/s there, so
    frame 2's estimate is held to ten times that, not to 1 mm/s; frame 0's
    own fit (condition number 5) is held to 1 mm/s.  R^2 and the inlier
    fraction are held to 1e-3 on every frame.
    """
    pts = torch.zeros((3, 3, 4))
    valid = torch.zeros((3, 3), dtype=torch.bool)
    proposed = torch.tensor([[0.1, 0.0, 0.0], [2.0, 0.0, 0.0], [0.3, 0.0, 0.0]])
    ref = ref_ground.Analysis(
        altitude=torch.ones(3), points=pts, valid=valid, count=torch.zeros(3, dtype=torch.long),
        proposed=proposed, r2=torch.tensor([0.5, 0.5, 0.1]),
        inlier_fraction=torch.tensor([0.6, 0.6, 0.6]), velocity=proposed[[0, 1, 1]],
        kappa=torch.tensor([5.0, 1000.0, 5.0]), source=torch.tensor([0, 1, 1]))
    fit_bound, carried_bound = ref_ground.solve_rounding(ref)
    assert float(fit_bound[1]) == pytest.approx(2.0 ** -24 * 1e6 * 2.0)
    assert torch.equal(carried_bound, fit_bound[[0, 1, 1]])
    assert groundvel.ROUNDING_MARGIN * float(carried_bound[0]) < 1e-3

    def mismatch(v0, v2, r2_2=0.1):
        out = {"points": pts[[0, 2]].numpy(), "valid": valid[[0, 2]].numpy(),
               "fit": np.array([[0.5, 0.6], [r2_2, 0.6]], np.float32),
               "velocity": np.array([[v0, 0, 0], [v2, 0, 0]], np.float32)}
        return groundvel.ground_numbers(np.ones(3, np.float32), out, ref, np.array([0, 2]),
                                        cell.radar, max_dets=512)["velocity_mismatch"]

    assert mismatch(0.1, 2.5) == 0.0  # 0.5 m/s inside 10 x 0.12 m/s
    assert mismatch(0.1, 3.5) == 0.5  # 1.5 m/s is not
    assert mismatch(0.102, 2.0) == 0.5  # a well-conditioned estimate off by 2 mm/s
    assert mismatch(0.1, 2.0, r2_2=0.2) == 0.5  # an R^2 off


def test_the_workload_file_is_found_by_the_harness():
    assert (BENCH_DIR / "workloads" / f"{CELL}.json").is_file()
    assert Cell.load(CELL).traffic_module().Run.UNITS == {"frames_per_s": "frames/s"}
