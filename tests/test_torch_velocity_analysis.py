"""RadVel's velocity analysis (``build_velocity_analysis_pipeline``) against its plain reference and the per-frame estimator.

The benchmark's configuration ``iwr6843ods-radvel-analysis-20hz``
(``port_bench/configs/``): upstream's ``velocity_analysis_config.yaml`` on
the 20 Hz ODS ``.cfg`` (OS-CFAR 1D 5 / 2 / 0.6 / 4, the altimeter at 0.25 m,
+-0.2 m zoom, 0.4 m search limit, precise; gates R^2 0.2 and inliers 0.5),
512 detection slots, 64 angle bins, RANSAC 10 samples, 0.15 m/s, 20 trials.
On the CPU, 96 frames of the benchmark's flight generator
(``port_bench/gen/ground_flight.py``) with its RANSAC draws:

- the pipeline against the plain reference (``port_bench/reference/ground.py``),
  on the same draws: altitudes within ``ALT_TOL_M``, the same detections in
  the same slots, points within ``POINT_TOL_M``, R^2 and inlier fractions
  within ``FIT_TOL``, and fits and carried estimates within ``VEL_TOL_M_S``
  where float32 rounding allows it (see the bars);
- chunks of 32 frames chained through ``final_altitude`` and
  ``final_velocity`` give what one call gives, bit for bit;
- the batched gates and carry equal the per-frame ``VelocityEstimator`` fed
  the same points and the same scores frame by frame;
- the standard geometry fits 2D ``(x, y)``: ``vz`` is 0, and the 2D fit
  equals the reference's;
- on a card (the ``cuda`` marker; ``python -m pytest --noconftest -p
  no:cacheprovider -m cuda tests/test_torch_velocity_analysis.py``): a call
  makes no host sync, chunks chain bit for bit, and the card's outputs meet
  the same bars against the reference computed there.

Bars, with their reasons:

- ``ALT_TOL_M`` = 1 mm: the altitude is a zoom bin's range, and a different
  pick moves it by a zoom step (about 6.5 mm); rounding moves it by float32
  ulps (measured: 1.2e-7 m);
- detections: equal.  The reference's FFTs and the program's DFT matrices
  round differently (about 1e-6 relative), which changes a CFAR decision only
  for a cell within that of its threshold: none of these frames has one;
- ``POINT_TOL_M`` = 1e-5 m: both sides take a point's range, Doppler and
  angles from the same grids, so a point either agrees to rounding
  (measured: equal) or moves by an angle bin, over 1 cm at these ranges;
- ``VEL_TOL_M_S`` = 1e-4 m/s and ``FIT_TOL`` = 1e-4, a tenth of the
  benchmark's check: the reference fits in float64 by the SVD, the program
  solves float32 normal equations, which may err by float32's roundoff times
  the squared condition number of the inlier directions times the fit
  (``reference.ground.solve_rounding``).  So a fit, or a carried estimate,
  is held to the larger of the bar and ``ROUNDING_MARGIN`` (10) times that,
  as the benchmark's check holds it.  Measured here: every frame within 1e-4
  but frame 0, whose 25 inliers lie nearly in a plane (condition number 92):
  the two sides give the same 30 m/s to within 4.6e-3 m/s, under its bound
  of 1.3e-2.  The R^2 and inlier fractions are held everywhere (measured:
  6e-8 and equal).  A rounding that flips a trial's inlier count would
  change the winner and fail these bars: none of these frames has one
  (about one frame in 500 of the benchmark's flights does, which its
  check's limit allows).
"""

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import build_velocity_analysis_pipeline, load_cfg
from mmwave_radar_processing_tpu_torch.point_cloud_processing import (
    VelocityEstimator,
    carry_passing,
    ego_vel_from_points,
    passes_gates,
)
from port_bench.gen import ground_flight
from port_bench.lib.harness import Cell
from port_bench.reference import ground as ref_ground
from port_bench.traffic.groundvel import ROUNDING_MARGIN, build_pipeline

torch.set_num_threads(2)  # tier-1 runs several xdist workers

CFG_PATH = "configs/6843_RadVel_ods_20Hz.cfg"
CELL = "ods20-groundvel-flight-bulk"
FRAMES, CHUNK = 96, 32
BIG_SEED = 2 ** 31 + 2027
ALT_TOL_M, POINT_TOL_M, VEL_TOL_M_S, FIT_TOL = 1e-3, 1e-5, 1e-4, 1e-4
FIELDS = ("points", "valid", "count", "altitude", "proposed", "r2", "inlier_fraction",
          "velocity")


@pytest.fixture(scope="module")
def cell():
    return Cell.load(CELL)


@pytest.fixture(scope="module")
def settings(cell):
    return ref_ground.settings(cell.config["processing"])


def _cfg(geometry):
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / CFG_PATH
    return load_cfg(str(path), array_geometry=geometry, array_direction="down")


@pytest.fixture(scope="module")
def flight(cell, settings):
    f = ground_flight.flight(cell.radar, FRAMES, BIG_SEED, "cpu")
    scores = ground_flight.scores(FRAMES, settings["ransac_max_trials"], settings["max_dets"],
                                  BIG_SEED, "cpu")
    return f, scores


@pytest.fixture(scope="module")
def pipe(settings):
    return build_pipeline(_cfg("ods"), settings, True, "cpu")


@pytest.fixture(scope="module")
def outputs(pipe, flight):
    f, scores = flight
    with torch.no_grad():
        return pipe(f.re, f.im, scores=scores)


@pytest.fixture(scope="module")
def reference(cell, settings, flight):
    f, scores = flight
    return ref_ground.analysis(f.re, f.im, scores, cell.radar, settings)


def test_the_entry_point_is_exported_and_the_fit_is_3d_for_ods(pipe, settings):
    from mmwave_radar_processing_tpu_torch import parallel

    assert parallel.build_velocity_analysis_pipeline is build_velocity_analysis_pipeline
    assert pipe.dims == 3 and pipe.ground.max_dets == settings["max_dets"] == 512


def test_altitudes_follow_the_reference(outputs, reference):
    assert outputs.altitude.shape == (FRAMES,)
    assert float((outputs.altitude - reference.altitude).abs().max()) <= ALT_TOL_M
    assert torch.equal(outputs.final_altitude, outputs.altitude[-1])


def test_detections_equal_the_reference(outputs, reference, settings):
    assert int(reference.count.max()) <= settings["max_dets"]  # nothing dropped
    assert torch.equal(outputs.count.long(), reference.count)
    assert torch.equal(outputs.valid, reference.valid)
    assert int(outputs.count.sum()) > 20 * FRAMES


def test_points_equal_the_reference(outputs, reference):
    gap = (outputs.points - reference.points).abs().amax(dim=-1)
    assert float(gap[outputs.valid].max()) <= POINT_TOL_M
    assert not outputs.points[~outputs.valid].any()


def _within(a, b, bound):
    """Each frame's largest gap is under ``VEL_TOL_M_S`` or ``ROUNDING_MARGIN`` x its float32 solve's bound."""
    gap = (a - b).abs().amax(-1).double()
    return bool((gap <= torch.clamp_min(ROUNDING_MARGIN * bound, VEL_TOL_M_S)).all())


def test_fits_and_carried_estimates_equal_the_reference(outputs, reference):
    fit_bound, carried_bound = ref_ground.solve_rounding(reference)
    assert _within(outputs.proposed, reference.proposed, fit_bound)
    assert _within(outputs.velocity, reference.velocity, carried_bound)
    assert float((outputs.r2 - reference.r2).abs().max()) <= FIT_TOL
    assert float((outputs.inlier_fraction - reference.inlier_fraction).abs().max()) <= FIT_TOL
    passed = passes_gates(outputs.r2, outputs.inlier_fraction, 0.2, 0.5)
    assert 0 < int(passed.sum()) < FRAMES  # the carry both takes and keeps
    assert torch.equal(outputs.final_velocity, outputs.velocity[-1])


def test_chunks_chained_through_both_carries_equal_one_call(pipe, flight, outputs):
    f, scores = flight
    parts, alt, vel = [], None, None
    with torch.no_grad():
        for s in range(0, FRAMES, CHUNK):
            part = pipe(f.re[s:s + CHUNK], f.im[s:s + CHUNK], scores=scores[s:s + CHUNK],
                        init_altitude=alt, init_velocity=vel)
            alt, vel = part.final_altitude, part.final_velocity
            parts.append(part)
    for name in FIELDS:
        assert torch.equal(torch.cat([getattr(p, name) for p in parts]),
                           getattr(outputs, name)), name
    assert torch.equal(alt, outputs.final_altitude) and torch.equal(vel, outputs.final_velocity)


def test_the_batched_carry_equals_the_per_frame_estimator(outputs, flight):
    _, scores = flight
    est = VelocityEstimator(_cfg("ods"), min_R2_threshold=0.2, min_inlier_percent=0.5,
                            device="cpu")
    for t in range(FRAMES):
        est._draw_scores = lambda n, trials=20, t=t: scores[t]
        current = est.process(points=outputs.points[t], valid=outputs.valid[t])
        np.testing.assert_array_equal(est.proposed_velocity_estimate,
                                      outputs.proposed[t].numpy())
        np.testing.assert_array_equal(current, outputs.velocity[t].numpy())


def test_carry_passing_keeps_the_last_passing_proposal():
    proposed = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    r2 = torch.tensor([0.1, 0.9, 0.1, 0.9, 0.1])
    inl = torch.tensor([0.9, 0.9, 0.9, 0.4, 0.9])
    init = torch.tensor([7.0, 8.0, 9.0])
    carried, final = carry_passing(proposed, r2, inl, init, min_r2_threshold=0.2,
                                   min_inlier_percent=0.5)
    want = torch.stack([init, proposed[1], proposed[1], proposed[1], proposed[1]])
    assert torch.equal(carried, want) and torch.equal(final, proposed[1])
    empty, final = carry_passing(proposed[:0], r2[:0], inl[:0], init, min_r2_threshold=0.2,
                                 min_inlier_percent=0.5)
    assert empty.shape == (0, 3) and torch.equal(final, init)


def test_the_standard_geometry_fits_2d(cell, settings, flight, outputs):
    f, scores = flight
    pipe = build_pipeline(_cfg("standard"), settings, True, "cpu")
    assert pipe.dims == 2
    with torch.no_grad():
        out = pipe(f.re, f.im, scores=scores)
    assert torch.equal(out.altitude, outputs.altitude) and torch.equal(out.valid, outputs.valid)
    assert not out.proposed[:, 2].any() and not out.velocity[:, 2].any()
    fit = ego_vel_from_points(out.points, out.valid, dims=2, scores=scores)
    assert torch.equal(out.proposed[:, :2], fit.coef)
    ref = ref_ground.analysis(f.re, f.im, scores, cell.radar, settings, dims=2)
    fit_bound, carried_bound = ref_ground.solve_rounding(ref)
    assert _within(out.proposed, ref.proposed, fit_bound)
    assert _within(out.velocity, ref.velocity, carried_bound)
    assert float((out.r2 - ref.r2).abs().max()) <= FIT_TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ground scan's recursion kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_on_the_card_no_host_sync_chunks_chain_and_the_reference_agrees(cuda, cell, settings):
    f = ground_flight.flight(cell.radar, 4 * CHUNK, BIG_SEED, cuda)
    scores = ground_flight.scores(4 * CHUNK, settings["ransac_max_trials"],
                                  settings["max_dets"], BIG_SEED, cuda)
    pipe = build_pipeline(_cfg("ods"), settings, True, cuda)
    with torch.no_grad():
        pipe(f.re, f.im, scores=scores)  # builds the recursion kernel
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            whole = pipe(f.re, f.im, scores=scores)
            first = pipe(f.re[:CHUNK], f.im[:CHUNK], scores=scores[:CHUNK])
            rest = pipe(f.re[CHUNK:], f.im[CHUNK:], scores=scores[CHUNK:],
                        init_altitude=first.final_altitude, init_velocity=first.final_velocity)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for name in FIELDS:
            assert torch.equal(torch.cat([getattr(first, name), getattr(rest, name)]),
                               getattr(whole, name)), name
        ref = ref_ground.analysis(f.re, f.im, scores, cell.radar, settings)
    assert float((whole.altitude - ref.altitude).abs().max()) <= ALT_TOL_M
    assert torch.equal(whole.valid, ref.valid)
    gap = (whole.points - ref.points).abs().amax(dim=-1)
    assert float(gap[whole.valid].max()) <= POINT_TOL_M
    assert _within(whole.velocity, ref.velocity, ref_ground.solve_rounding(ref)[1])
    assert float((whole.r2 - ref.r2).abs().max()) <= FIT_TOL
