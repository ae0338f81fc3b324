"""The synthetic-aperture cell's pieces: its files, the flight generator, the reference, the cost, the readers, the faults.

CPU only.  The reference is held to a direct loop, frame by frame in
float64 numpy, on a tiny flight; the runs are of the tiny copy of the cell
(``conftest.bench_copy``), whose mix is cut to a few frames.
"""

import json
import time

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR, CHECKOUT
from port_bench.cost import roofline
from port_bench.cost.sar import depth_call
from port_bench.gen import flight, scene
from port_bench.lib import stages as st
from port_bench.lib.harness import Cell, metric_modules, run_cell
from port_bench.reference import sar as ref_sar
from port_bench.traffic import sar as traffic_sar

CELL = "radsar1843-flight-bulk"
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
BIG_SEED = 2 ** 31 + 4321
LIMITS = {"gate_mismatch", "depth_mismatch", "peak_error"}
STAGE_METRICS = {f"sa.{s}.ms_per_kframe": f"mmw.sa.{s}"
                 for s in ("window", "phases", "product", "range_dft", "depth")}


@pytest.fixture(scope="module")
def cell():
    return Cell.load(CELL)


def small(p, **changes):
    """The cell's processing at a small aperture and grid."""
    return dict(p, num_frames=3, az_deg=[-30.0, 30.0, 6], el_deg=[-15.0, 15.0, 2], **changes)


def test_the_cell_its_configuration_and_its_mix(cell):
    assert cell.mix == {**cell.mix, "kind": "sar", "frames": 4096, "batch": 1024}
    assert cell.spec["chips"] == 1 and set(cell.spec["limits"]) == LIMITS
    assert cell.spec["sample_frames"] == 1024
    entry = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (entry["config"], entry["traffic"], entry["why"]) == (
        cell.spec["config"], cell.spec["traffic"], cell.spec["why"])
    p = cell.config["processing"]
    assert (p["num_frames"], p["az_deg"], p["el_deg"]) == (8, [-30.0, 30.0, 60], [-15.0, 15.0, 16])
    assert (p["min_vel"], p["max_vel"], p["max_vel_stdev"]) == (
        [0.17, 0.0, 0.0], [0.25, 0.05, 0.05], [0.1, 0.1, 0.1])
    assert set(cell.config["assumed"]) == {"num_frames", "el_deg", "flight", "batch"}
    assert cell.config["reduced"] == [] and cell.config["array_geometry"] == "standard"
    radar = cell.radar
    assert (radar.num_rx, radar.ns, radar.loops, radar.cpl) == (4, 100, 100, 2)
    assert ref_sar.frame_period_s(cell.config["cfg_lines"]) == pytest.approx(0.1)
    assert len(ref_sar.selected_chirps(radar, 0, 1)) == 100
    frames_per_s = next(m for m in BENCH["end_to_end"] if m["name"] == "frames_per_s")
    assert CELL in frames_per_s["workloads"]


def test_every_reader_of_the_kind_is_listed_for_the_cell():
    listed = {m["name"]: m for m in BENCH["per_layer"] if CELL in m.get("workloads", [])}
    kind = {name for name, m in metric_modules().items() if "sar" in m.KINDS}
    assert set(listed) == kind == {*STAGE_METRICS, "sa.launches_per_kframe", "sa.roofline_pct"}
    for name, module in metric_modules().items():
        if name in kind:
            assert module.KINDS == ("sar",) and listed[name]["workloads"] == [CELL]


def test_same_seed_same_flight_and_the_track_first(cell):
    radar = cell.radar
    a = flight.flight(radar, 0.1, 6, BIG_SEED, "cpu", chunk=4)
    b = flight.flight(radar, 0.1, 6, BIG_SEED, "cpu", chunk=4)
    c = flight.flight(radar, 0.1, 6, BIG_SEED + 1, "cpu", chunk=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.re, c.re)
    assert a.re.shape == (6, 4, 100, 200) and a.re.dtype == torch.float32
    track = flight.track(6, scene.generator(BIG_SEED, "cpu"), "cpu")
    assert torch.equal(track.vels.to(torch.float32), a.vels)


@pytest.mark.parametrize("seed", [BIG_SEED, 7, 2 ** 40 + 3])
def test_the_gate_passes_75_to_90_percent_of_a_flight(cell, seed):
    p = cell.config["processing"]
    n, f = 4096, p["num_frames"]
    track = flight.track(n, scene.generator(seed, "cpu"), "cpu")
    vel = track.vels.to(torch.float32)
    idx = torch.arange(n)[:, None] + torch.arange(-f + 1, 1)[None, :]
    windows = torch.where((idx < 0)[:, :, None], 0.0, vel[idx.clamp_min(0)])
    share = float(ref_sar.gate(windows, p).float().mean())
    assert 0.75 <= share <= 0.90, share
    assert 0.85 <= float(track.cruise.float().mean()) <= 0.95
    cruise = track.vels[track.cruise]
    assert abs(float(cruise[:, 0].mean()) - 0.21) < 0.012
    assert float(cruise[:, 1:].std()) == pytest.approx(0.01, rel=0.1)


def test_reflectors_in_view(cell):
    f = flight.flight(cell.radar, 0.1, 40, BIG_SEED, "cpu", chunk=8)
    assert 8 <= float(f.in_view.float().mean()) <= 60


def direct(re, im, vels, t, radar, p, frame_dt):
    """One frame's depth map, written out in float64 numpy: the aperture, the gate, the sums."""
    f, rx = p["num_frames"], p["receiver_idx"]
    chirps = ref_sar.selected_chirps(radar, p["chirp_cfg_idx"], p["stride"])
    frames = [t - f + 1 + i for i in range(f)]
    x = np.stack([(re[k, rx] + 1j * im[k, rx]).numpy()[:, chirps] if k >= 0
                  else np.zeros((radar.ns, len(chirps))) for k in frames])  # [F, ns, C]
    v = np.stack([vels[k].double().numpy() if k >= 0 else np.zeros(3) for k in frames])
    lo, hi, sd = (np.asarray(p[k]) for k in ("min_vel", "max_vel", "max_vel_stdev"))
    u = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-6)
    ok = bool(np.all((np.abs(v) >= lo) & (np.abs(v) <= hi)) and np.all(v.std(axis=0) <= sd)
              and np.all(u @ u.T > 0.95))
    t_c = (chirps - (radar.chirps - 1)) * radar.chirp_period_s
    pose, pos = np.zeros(3), [None] * f
    for i in range(f - 1, -1, -1):
        pos[i] = 2 * t_c[None, :] * v[i][:, None] + pose[:, None]
        pose = pose - 2 * v[i] * frame_dt
    pos = np.concatenate(pos, axis=1)  # [3, E]
    az, el = np.meshgrid(ref_sar.angles_rad(p["az_deg"]), ref_sar.angles_rad(p["el_deg"]),
                         indexing="ij")
    d = np.stack([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)], -1)
    d = d.reshape(-1, 3)
    data = x.transpose(1, 0, 2).reshape(radar.ns, -1) * np.hamming(pos.shape[1])
    beam = data @ np.exp(2j * np.pi * (d @ pos) / radar.lambda_m).T  # [ns, A]
    n = np.arange(radar.ns)
    spec = (np.hanning(radar.ns)[:, None]
            * np.exp(-2j * np.pi * np.outer(n, n) / radar.ns)).T @ beam
    mag = np.abs(spec)
    peak = mag.max(axis=0)
    db = 20 * np.log10(peak + 1e-12)
    keep = (db >= db.max() - p["depth_floor_db"]) & ok
    return np.where(keep, mag.argmax(axis=0), -1), np.where(ok, peak, 0.0), ok


def test_the_reference_equals_a_direct_loop(cell):
    radar, p = cell.radar, small(cell.config["processing"])
    f = flight.flight(radar, 0.1, 9, BIG_SEED, "cpu", chunk=4)
    frames = np.array([0, 2, 3, 5, 8])
    ref = ref_sar.depth_maps(f.re, f.im, f.vels, frames, radar, p, 0.1, block=2)
    assert ref.ok.tolist() == [False, True, True, True, True]  # frames 0 and 1 see zeros
    for row, t in enumerate(frames):
        bins, peak, ok = direct(f.re, f.im, f.vels, t, radar, p, 0.1)
        assert ok == bool(ref.ok[row])
        np.testing.assert_array_equal(ref.depth_bin[row].numpy(), bins)
        scale = max(peak.max(), 1e-30)
        assert np.abs(ref.peak[row].numpy() - peak).max() / scale < 1e-5


def test_the_cost_of_a_call():
    ops, nbytes = depth_call(1024, 100, 100, 8, 960)
    assert ops == 1024 * (8 * 100 * 800 * 960 + 8 * 100 * 100 * 960)
    assert nbytes == 1024 * (100 * 100 * 8 + 960 * 8 + 1)
    per_frame = roofline.bound_seconds(ops, nbytes) / 1024
    assert per_frame * 1e6 == pytest.approx(10.316, abs=1e-3)  # compute-bound: 691 MFLOP
    assert ops / roofline.PEAK_F32_FLOPS > nbytes / roofline.PEAK_HBM_BYTES_S


def _stages(cell_frames=2048):
    """Hand-built stages: one call of the pipeline span with nested stages, and an outside copy."""
    events = [{"cat": "user_annotation", "name": n, "ts": ts, "dur": dur, "tid": 1}
              for n, ts, dur in (("mmw.sa", 0, 100), ("mmw.sa.window", 0, 10),
                                 ("mmw.sa.phases", 10, 20), ("mmw.sa.product", 30, 40),
                                 ("mmw.sa.range_dft", 70, 10), ("mmw.sa.depth", 80, 10))]
    launches = {1: 5, 2: 15, 3: 35, 4: 75, 5: 85, 6: 95, 7: 150}
    durations = {1: 300, 2: 2000, 3: 5000, 4: 700, 5: 100, 6: 50, 7: 400}
    for corr, ts in launches.items():
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                       "tid": 1, "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": f"k{corr}", "ts": 1000, "dur": durations[corr],
                       "tid": 7, "args": {"correlation": corr}})
    return st.Stages.from_events(events, frames=cell_frames)


def test_the_readers_read_the_stages(cell):
    stages, modules = _stages(), metric_modules()
    ctx = {"cell": cell, "stages": stages}
    for name, span in STAGE_METRICS.items():
        want = stages.stage_seconds(span) * 1e3 * 1024 / 2048
        assert modules[name].read(ctx) == pytest.approx(want), name
    assert modules["sa.launches_per_kframe"].read(ctx) == 6 * 1024 / 2048
    bound = roofline.bound_seconds(*depth_call(2048, 100, 100, 8, 960))
    inside = (300 + 2000 + 5000 + 700 + 100 + 50) / 1e6  # the copy at 150 is outside mmw.sa
    assert modules["sa.roofline_pct"].read(ctx) == pytest.approx(100 * bound / inside)
    bare = {"cell": cell, "stages": st.Stages(frames=2048)}
    for name in [*STAGE_METRICS, "sa.launches_per_kframe", "sa.roofline_pct"]:
        assert modules[name].read(bare) is None, name


def _run(root, **kw):
    return run_cell(f"tiny-{CELL}", seed=BIG_SEED, seconds=0.05, trace=False, device="cpu",
                    t_start=time.perf_counter(), root=root, **kw)


def test_the_tiny_cell_is_correct(bench_copy):
    result = _run(bench_copy)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == LIMITS and set(result["metrics"]) == {"frames_per_s",
                                                                           "setup_s"}


def test_the_control_fails_on_the_depth_maps(bench_copy):
    checks = _run(bench_copy, control=True)["checks"]
    assert checks["gate_mismatch"]["value"] == 0  # no product in the gate
    assert checks["peak_error"]["value"] > checks["peak_error"]["limit"]


@pytest.mark.parametrize("fault,number", [("aperture_reset", "gate_mismatch"),
                                          ("history_late", "peak_error"),
                                          ("depth_off", "depth_mismatch")])
def test_each_planted_fault_reads_false(bench_copy, fault, number):
    result = _run(bench_copy, fault=fault)
    assert result["correct"] is False
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


def test_an_unknown_fault_is_refused(bench_copy):
    with pytest.raises(ValueError, match="unknown fault"):
        _run(bench_copy, fault="no_such_fault")


def test_the_numbers_of_outputs_against_the_reference():
    ref = ref_sar.Depth(torch.tensor([[1, 2], [3, -1], [0, 0]], dtype=torch.int32),
                        torch.tensor([[4.0, 2.0], [1.0, 0.5], [0.0, 0.0]]),
                        torch.tensor([True, True, False]))
    nums = traffic_sar.sar_numbers(np.array([[1, 3], [3, -1], [0, 0]]),
                                   np.array([[4.0, 2.1], [1.0, 0.5], [0.0, 0.0]]),
                                   np.array([True, False, False]), ref)
    assert nums == pytest.approx({"gate_mismatch": 1 / 3, "depth_mismatch": 0.5,
                                  "peak_error": 0.1 / 4.0})


def test_the_workload_file_is_found_by_the_harness():
    assert (BENCH_DIR / "workloads" / f"{CELL}.json").is_file()
    assert Cell.load(CELL).traffic_module().Run.UNITS == {"frames_per_s": "frames/s"}
