"""The synthetic-aperture pipeline streamed in batches, and its depth head, on the CPU.

RadSAR's IWR1843 configuration (``configs/RadSAR_1843_official.cfg``,
standard geometry: 100 samples, chirp configuration 0 gives 100 chirps a
frame) at a small aperture, on frames of the benchmark's flight generator
(``port_bench/gen/flight.py``) and on seeded random planes, over two grids:
12 x 3 = 36 directions, fewer than the 100 chirps, where the range DFT is
taken of the beams after the element sum, and 12 x 9 = 108, more, where it
is taken of each frame's chirps before it (``range_dft_first``):

- a recording cut into batches of 1, 3 and 5 frames, the aperture carried
  from batch to batch, gives the outputs of one call over the whole
  recording, and JAX's scan over it;
- the depth head equals the JAX package's plotter (its numpy depth map) on
  the same response, and the port's plotter draws the same map;
- the pipeline equals the benchmark's plain reference
  (``port_bench/reference/sar.py``), which builds each frame's aperture from
  the whole recording;
- at 108 directions the DFT-first order equals the element sum followed by
  the DFT of the beams, written out here;
- the carried state holds the last ``F-1`` frames' raw chirps.

Bars, each with its reason:

- the gate: exact everywhere (the same float32 comparisons of the same
  velocities);
- batches against one call: depth bins exact and magnitudes within
  ``STREAM_ATOL`` = 1e-6 of the largest (each frame's products are the same
  float32 sums, whichever batch holds the frame; measured: equal);
- the DFT-first order against the DFT of the beams: depth bins exact and
  magnitudes within ``STREAM_ATOL`` of the largest (the same linear maps
  rounded in another order; measured 4.5e-7);
- against JAX: magnitudes within ``MAP_RTOL`` = 1e-4, atol 1e-4 of the
  largest, the bars of the other synthetic-aperture tests (the JAX scan
  forms the products as split real matrix products, in another order);
- against the reference: depth bins exact, peaks within ``REF_PEAK_TOL`` =
  1e-5 of the frame's largest (element sums of 400 terms and a 100-point
  DFT, in another order and as real products; measured 2.9e-6 and 4.0e-6);
- depth maps against the plotter: exact on the same magnitudes (the same
  float32 formula; numpy's and torch's ``log10`` agree but at a tie with
  the floor, which these scenes do not hold).
"""

import json
from pathlib import Path
from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mmwave_radar_processing_tpu.plotting as jplot  # noqa: E402
from mmwave_radar_processing_tpu.config import load_cfg as jax_load_cfg  # noqa: E402
from mmwave_radar_processing_tpu.parallel.beamform_pipeline import (  # noqa: E402
    build_synthetic_aperture_pipeline as build_jax,
)
from mmwave_radar_processing_tpu_torch import (  # noqa: E402
    SyntheticArrayBeamformerProcessor,
    build_synthetic_aperture_pipeline,
    load_cfg,
)
from mmwave_radar_processing_tpu_torch.parallel import ApertureDepth, ApertureState  # noqa: E402
from mmwave_radar_processing_tpu_torch.plotting import PlotterSyntheticArrayData  # noqa: E402
from mmwave_radar_processing_tpu_torch.ops import dft  # noqa: E402
from mmwave_radar_processing_tpu_torch.processors.synthetic_array import (  # noqa: E402
    chained_geometry,
    depth_map,
    steering_phases,
    velocity_gate,
)
from port_bench.gen import flight as gen_flight  # noqa: E402
from port_bench.reference import sar as ref_sar  # noqa: E402
from port_bench.reference.radar import parse_cfg  # noqa: E402

torch.set_num_threads(2)  # tier-1 runs several xdist workers

ROOT = Path(__file__).resolve().parents[1]
CFG_PATH = ROOT / "configs" / "RadSAR_1843_official.cfg"
STREAM_ATOL = 1e-6
MAP_RTOL = 1e-4
REF_PEAK_TOL = 1e-5
N_FRAMES = 11
#: the deployment's processing at a small aperture and grid
PROCESSING = dict(receiver_idx=0, chirp_cfg_idx=0, stride=1, num_frames=4,
                  az_deg=[-30.0, 30.0, 12], el_deg=[-15.0, 15.0, 3],
                  min_vel=[0.17, 0.0, 0.0], max_vel=[0.25, 0.05, 0.05],
                  max_vel_stdev=[0.1, 0.1, 0.1], depth_floor_db=40.0)
#: the same at 12 x 9 = 108 directions, more than a frame's 100 chirps
WIDE = dict(PROCESSING, el_deg=[-15.0, 15.0, 9])
GRIDS = pytest.mark.parametrize("processing", [PROCESSING, WIDE], ids=["grid36", "grid108"])


def pipeline_kw(p=PROCESSING):
    return dict(receiver_idx=p["receiver_idx"], chirp_cfg_idx=p["chirp_cfg_idx"],
                stride=p["stride"], num_frames=p["num_frames"],
                az_angle_bins_rad=ref_sar.angles_rad(p["az_deg"]),
                el_angle_bins_rad=ref_sar.angles_rad(p["el_deg"]),
                min_vel=np.asarray(p["min_vel"]), max_vel=np.asarray(p["max_vel"]),
                max_vel_stdev=np.asarray(p["max_vel_stdev"]))


@pytest.fixture(scope="module")
def cfg():
    return load_cfg(str(CFG_PATH), array_geometry="standard")


@pytest.fixture(scope="module")
def radar():
    return parse_cfg(CFG_PATH.read_text().splitlines())


@pytest.fixture(scope="module")
def flight(radar):
    """``N_FRAMES`` frames of a flight over stationary reflectors: cruise, all inside the gate."""
    f = gen_flight.flight(radar, 0.1, N_FRAMES, 2 ** 31 + 21, "cpu", chunk=4)
    return f.re, f.im, f.vels


@pytest.fixture(scope="module")
def random_recording(cfg):
    """Seeded random planes and a track that leaves the gate for two frames."""
    g = torch.Generator().manual_seed(21)
    shape = (N_FRAMES, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    re, im = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    vels = torch.tensor([0.21, 0.0, 0.0]) + 0.01 * torch.randn((N_FRAMES, 3), generator=g)
    vels[5:7, 0] = 0.35  # a speed-up: the gate fails on frames 5-9
    return re, im, vels


def _stream(pipe, re, im, vels, batch):
    state, outs = pipe.init_state(), []
    for s in range(0, re.shape[0], batch):
        out, state = pipe(re[s:s + batch], im[s:s + batch], vels[s:s + batch], state)
        assert isinstance(state, ApertureState)
        outs.append(out)
    return [torch.cat(parts) for parts in zip(*outs)]


@GRIDS
@pytest.mark.parametrize("batch", [1, 3, 5])
@pytest.mark.parametrize("output", ["magnitude", "depth"])
def test_batches_with_the_carried_aperture_equal_one_call(cfg, flight, batch, output, processing):
    re, im, vels = flight
    pipe = build_synthetic_aperture_pipeline(cfg, device="cpu", output=output,
                                             **pipeline_kw(processing))
    whole = pipe(re, im, vels)
    parts = _stream(pipe, re, im, vels, batch)
    assert torch.equal(parts[-1], whole[-1])  # the gate
    assert whole[-1].tolist() == [False] * 3 + [True] * (N_FRAMES - 3)
    if output == "depth":
        assert isinstance(whole, ApertureDepth) and whole.depth_bin.dtype == torch.int32
        assert torch.equal(parts[0], whole.depth_bin)
    values, want = parts[1 if output == "depth" else 0], whole[1 if output == "depth" else 0]
    torch.testing.assert_close(values, want, rtol=0, atol=STREAM_ATOL * float(want.max()))


@GRIDS
@pytest.mark.parametrize("recording", ["flight", "random_recording"])
def test_streamed_batches_equal_the_jax_scan(cfg, recording, request, processing):
    re, im, vels = request.getfixturevalue(recording)
    kw = pipeline_kw(processing)
    pipe = build_synthetic_aperture_pipeline(cfg, device="cpu", **kw)
    mag, ok = _stream(pipe, re, im, vels, 3)
    want_mag, want_ok = build_jax(jax_load_cfg(str(CFG_PATH), array_geometry="standard"),
                                  **kw)(re.numpy(), im.numpy(), vels.numpy())
    assert ok.tolist() == np.asarray(want_ok).tolist()
    want_mag = np.asarray(want_mag)
    np.testing.assert_allclose(mag.numpy(), want_mag, rtol=MAP_RTOL,
                               atol=MAP_RTOL * np.abs(want_mag).max())


def test_a_state_of_another_shape_is_refused(cfg, flight):
    re, im, vels = flight
    pipe = build_synthetic_aperture_pipeline(cfg, device="cpu", **pipeline_kw())
    state = pipe.init_state()
    with pytest.raises(ValueError, match="state"):
        pipe(re, im, vels, ApertureState(state.adc[1:], state.vel))
    with pytest.raises(ValueError, match="output"):
        build_synthetic_aperture_pipeline(cfg, device="cpu", output="cube")


@pytest.mark.parametrize("processing, first", [(PROCESSING, False), (WIDE, True)],
                         ids=["grid36", "grid108"])
def test_the_range_dft_goes_first_where_the_grid_outnumbers_the_chirps(cfg, processing, first):
    pipe = build_synthetic_aperture_pipeline(cfg, device="cpu", **pipeline_kw(processing))
    assert len(pipe.valid_idx) == 100 and pipe.n_az * pipe.n_el in (36, 108)
    assert pipe.range_dft_first is first
    # the builder's own grid, 60 x 1 directions, keeps the DFT after the element sum
    assert not build_synthetic_aperture_pipeline(cfg, device="cpu").range_dft_first


def _product_then_dft(pipe, re, im, vels):
    """Magnitudes ``[T, ns, A]`` and gate: the element sum of the raw chirps, then the DFT of the beams."""
    t, f, rx = re.shape[0], pipe.num_frames, pipe.receiver_idx
    head = pipe.init_state()
    ring = torch.cat([head.adc, torch.complex(re[:, rx], im[:, rx])[:, :, pipe.valid_idx]])
    data = ring.unfold(0, f, 1).permute(0, 1, 3, 2).reshape(t, pipe.ns, -1) * pipe.element_window
    vel = torch.cat([head.vel, vels]).unfold(0, f, 1).transpose(1, 2)  # [T, F, 3]
    ok = velocity_gate(vel, pipe.min_vel, pipe.max_vel, pipe.max_vel_stdev)
    positions = chained_geometry(vel, pipe.chirp_times_s, pipe.frame_dt).transpose(1, 2)
    phases = steering_phases(pipe.steering, positions.reshape(t, 3, -1), pipe.lambda_m)
    beams = data @ phases.transpose(1, 2)  # [T, ns, A]
    return dft.cabs(pipe.rng_dft.transpose(0, 1) @ beams), ok


def test_the_dft_first_order_equals_the_dft_of_the_beams(cfg, flight):
    re, im, vels = flight
    kw = pipeline_kw(WIDE)
    pipe = build_synthetic_aperture_pipeline(cfg, device="cpu", **kw)
    mag, ok = pipe(re, im, vels)
    depth = build_synthetic_aperture_pipeline(cfg, device="cpu", output="depth", **kw)(
        re, im, vels)
    want, want_ok = _product_then_dft(pipe, re, im, vels)
    assert torch.equal(ok, want_ok) and ok.sum() == N_FRAMES - 3
    want = torch.where(ok[:, None, None], want, 0.0)
    torch.testing.assert_close(mag.reshape(want.shape), want, rtol=0,
                               atol=STREAM_ATOL * float(want.max()))
    want_bin, _ = depth_map(want, WIDE["depth_floor_db"])
    assert torch.equal(depth.depth_bin, torch.where(ok[:, None], want_bin, -1).to(torch.int32))


@GRIDS
def test_the_carried_state_holds_the_last_frames_raw_chirps(cfg, flight, processing):
    re, im, vels = flight
    pipe = build_synthetic_aperture_pipeline(cfg, device="cpu", **pipeline_kw(processing))
    _, state = pipe(re[:6], im[:6], vels[:6], pipe.init_state())
    _, state = pipe(re[6:], im[6:], vels[6:], state)
    keep = pipe.num_frames - 1
    rx = processing["receiver_idx"]
    raw = torch.complex(re[-keep:, rx], im[-keep:, rx])[:, :, pipe.valid_idx]
    assert torch.equal(state.adc, raw)
    assert torch.equal(state.vel, vels[-keep:])


def _jax_depth(mag, processor, floor_db=40.0):
    """The JAX package's plotter's depth map of one ``[range, az, el]`` response (what it draws)."""
    fig, ax = plt.subplots()
    try:
        image = jplot.PlotterSyntheticArrayData(None).plot_depth_map(mag, processor, ax=ax,
                                                                     floor_dB=floor_db)
        return np.ma.filled(image.get_array(), np.nan).T
    finally:
        plt.close(fig)


def test_depth_head_equals_the_plotters_depth_map(cfg, flight):
    re, im, vels = flight
    kw = pipeline_kw()
    mag, ok = build_synthetic_aperture_pipeline(cfg, device="cpu", **kw)(re, im, vels)
    depth = build_synthetic_aperture_pipeline(cfg, device="cpu", output="depth", **kw)(
        re, im, vels)
    processor = SyntheticArrayBeamformerProcessor(cfg, device="cpu", **kw)
    bins = np.asarray(processor.range_bins)
    n_az, n_el = len(kw["az_angle_bins_rad"]), len(kw["el_angle_bins_rad"])
    for t in np.flatnonzero(ok.numpy()):
        want = _jax_depth(mag[t].numpy(), processor)
        got_bins = depth.depth_bin[t].numpy().reshape(n_az, n_el)
        got = np.where(got_bins >= 0, bins[np.maximum(got_bins, 0)], np.nan)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(depth.peak[t].numpy(), mag[t].amax(dim=0).reshape(-1))
    assert not depth.ok[~ok].any() and (depth.depth_bin[~ok] == -1).all()
    assert (depth.peak[~ok] == 0).all()


def test_the_floor_cuts_what_lies_below_it():
    """Kept at -39.99 dB, cut at -40.001 dB, as the JAX package's plotter; a tie on the floor is kept.

    The tie is torch's alone: numpy's float32 ``log10(1000)`` is 3.0000002
    where torch's is 3, so the JAX package's numpy plotter puts that
    direction one ulp below the floor.
    """
    mag = torch.ones(5, 4)  # [range, directions]
    mag[2, 0], mag[3, 1], mag[1, 2] = 1000.0, 10.001, 9.999
    bins, peak = depth_map(mag, floor_db=40.0)
    assert bins.tolist() == [2, 3, -1, -1]
    assert peak.tolist() == pytest.approx([1000.0, 10.001, 9.999, 1.0])
    proc = SimpleNamespace(range_bins=np.arange(5.0), az_angle_bins_rad=np.array([0.0, 0.1]),
                           el_angle_bins_rad=np.array([0.0, 0.1]))
    want = _jax_depth(mag.reshape(5, 2, 2).numpy(), proc)
    np.testing.assert_array_equal(want.reshape(-1), [2.0, 3.0, np.nan, np.nan])
    mag[1, 2] = 10.0  # 20 log10(10) = 20 = 60 - 40 in torch's float32
    assert depth_map(mag, floor_db=40.0)[0].tolist() == [2, 3, 1, -1]


def test_the_ports_plotter_draws_the_jax_plotters_depth_map(cfg, flight):
    re, im, vels = flight
    kw = pipeline_kw()
    mag, ok = build_synthetic_aperture_pipeline(cfg, device="cpu", **kw)(re, im, vels)
    processor = SyntheticArrayBeamformerProcessor(cfg, device="cpu", **kw)
    t = int(np.flatnonzero(ok.numpy())[-1])
    fig, ax = plt.subplots()
    try:
        image = PlotterSyntheticArrayData(cfg).plot_depth_map(mag[t], processor, ax=ax)
        got = np.ma.filled(image.get_array(), np.nan).T
    finally:
        plt.close(fig)
    np.testing.assert_array_equal(got, _jax_depth(mag[t].numpy(), processor))


@GRIDS
@pytest.mark.parametrize("recording", ["flight", "random_recording"])
def test_pipeline_equals_the_plain_reference(cfg, radar, recording, request, processing):
    re, im, vels = request.getfixturevalue(recording)
    pipe = build_synthetic_aperture_pipeline(cfg, device="cpu", output="depth",
                                             depth_floor_db=processing["depth_floor_db"],
                                             **pipeline_kw(processing))
    got = ApertureDepth(*_stream(pipe, re, im, vels, 4))
    frames = np.arange(N_FRAMES)
    ref = ref_sar.depth_maps(re, im, vels, frames, radar, processing, 0.1, block=3)
    assert got.ok.tolist() == ref.ok.tolist()
    assert got.ok.any() and not got.ok.all()
    assert torch.equal(got.depth_bin, ref.depth_bin)
    scale = ref.peak.amax(dim=1, keepdim=True).clamp_min(1e-30)
    assert float(((got.peak - ref.peak).abs() / scale).max()) <= REF_PEAK_TOL


def test_the_references_tf32_control_moves_the_peaks(radar, flight):
    re, im, vels = flight
    frames = np.arange(4, N_FRAMES)
    exact = ref_sar.depth_maps(re, im, vels, frames, radar, PROCESSING, 0.1)
    rounded = ref_sar.depth_maps(re, im, vels, frames, radar, PROCESSING, 0.1, tf32=True)
    assert torch.equal(exact.ok, rounded.ok)
    error = (exact.peak - rounded.peak).abs().amax(dim=1) / exact.peak.amax(dim=1)
    assert float(error.max()) > 100 * REF_PEAK_TOL


def test_the_configuration_file_is_the_cfg(radar):
    """The benchmark's configuration holds the repository's ``.cfg`` lines and this deployment."""
    spec = json.loads((ROOT / "port_bench" / "configs" / "iwr1843-radsar-10hz.json").read_text())
    lines = [ln for ln in CFG_PATH.read_text().splitlines() if ln.strip() and "%" not in ln]
    assert spec["cfg_lines"] == lines
    assert parse_cfg(spec["cfg_lines"]) == radar
    assert ref_sar.frame_period_s(spec["cfg_lines"]) == pytest.approx(0.1)
    assert (radar.ns, radar.loops, radar.cpl, radar.num_rx) == (100, 100, 2, 4)
