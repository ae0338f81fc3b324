"""The port's ``plotting/`` against the JAX package's, on the CPU.

A 4-frame simulated recording (a ground return drawing nearer frame by
frame and a moving target, odometry at (0.2, 0.01, 0) m/s) is processed by
the JAX processors and by the port's (``device="cpu"``: tensors, which the
plotters take as they are).  Each plotter draws both packages' results for
the same frame; what the two figures show agrees:

- floored dB maps (images and meshes) within 0.1 dB, their extents,
  meshes and bins within 1e-6;
- dB curves within 0.1 dB where within 40 dB of their peak, other curves
  (raw ADC, velocity, altitude, patterns) at rtol 1e-4 and atol 1e-4 of
  their maximum, scatter positions likewise;
- the movie generators write the same number of frames, each frame's
  panels at those bars (the odometry movie's points estimator draws from
  the JAX key stream, so both fit alike);
- ``AnalysisPlotter``'s lines within 1e-6, its histograms equal.
"""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import mmwave_radar_processing_tpu.plotting as jplot
import mmwave_radar_processing_tpu.processors as jproc
import mmwave_radar_processing_tpu_torch.plotting as tplot
import mmwave_radar_processing_tpu_torch.processors as tproc
from mmwave_radar_processing_tpu.analysis import VelocityAnalyzer as JaxAnalyzer
from mmwave_radar_processing_tpu.config import load_cfg as jax_load_cfg
from mmwave_radar_processing_tpu.data.cpsl_dataset import CpslDS as JaxCpslDS
from mmwave_radar_processing_tpu.point_cloud_processing import (
    VelocityEstimator as JaxPointsVelocityEstimator,
)
from mmwave_radar_processing_tpu_torch import load_cfg
from mmwave_radar_processing_tpu_torch.analysis import VelocityAnalyzer
from mmwave_radar_processing_tpu_torch.data import (
    CpslDS, PointTarget, Scene, make_odom_rows, simulate_frame, write_dataset,
)
from mmwave_radar_processing_tpu_torch.point_cloud_processing import (
    VelocityEstimator as PointsVelocityEstimator,
)
from mmwave_radar_processing_tpu_torch.processors.base import to_host
from test_torch_velocity_estimator import JaxKeyStream

torch.set_num_threads(2)

DB_TOL, DB_SPAN, RTOL, ATOL_OF_MAX, GRID_ATOL = 0.1, 40.0, 1e-4, 1e-4, 1e-6
FRAMES = 4
VEL = (0.2, 0.01, 0.0)
ALTIMETER = dict(min_altitude_m=0.25, zoom_search_region_m=0.2, altitude_search_limit_m=0.4)
SA = dict(num_frames=2, min_vel=np.array([0.15, 0.0, 0.0]), max_vel=np.array([0.3, 0.05, 0.05]))
AZ, EL = [0, 3, 4, 7], [9, 8, 5, 4]


@pytest.fixture(scope="module")
def cfgs(flagship_cfg_path):
    return (jax_load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down"),
            load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down"))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory, cfgs):
    """The recording as each package's ``CpslDS``."""
    root = str(tmp_path_factory.mktemp("plotting") / "rec")
    rng = np.random.default_rng(0)
    frames = []
    for i in range(FRAMES):
        scene = Scene(targets=[PointTarget(range_m=0.6 + 0.05 * i, rcs=4.0),
                               PointTarget(range_m=1.5, azimuth_rad=0.3, rcs=2.0,
                                           velocity_m_s=0.4)], noise_sigma=0.03)
        frames.append(simulate_frame(cfgs[1], scene, rng))
    write_dataset(root, np.stack(frames), odom=np.stack([make_odom_rows(VEL)] * FRAMES))
    return JaxCpslDS(root), CpslDS(root)


def drawn(fig):
    """Each Axes of ``fig``: images, meshes, lines, scatters, bar heights and texts, on the host."""
    out = []
    for ax in fig.axes:
        meshes = [c for c in ax.collections if isinstance(c, matplotlib.collections.QuadMesh)]
        scatters = [c for c in ax.collections if isinstance(c, matplotlib.collections.PathCollection)]
        out.append({
            "images": [(np.ma.getdata(im.get_array()).astype(float), im.get_extent())
                       for im in ax.images],
            "meshes": [(np.ma.getdata(m.get_array()).astype(float),
                        np.asarray(m.get_coordinates(), float)) for m in meshes],
            "lines": [(np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float),
                       ln.get_label()) for ln in ax.lines],
            "scatters": [np.asarray(s.get_offsets(), float) for s in scatters],
            "bars": [p.get_height() for p in ax.patches if hasattr(p, "get_height")],
            "texts": (ax.get_title(), ax.get_xlabel(), ax.get_ylabel()),
            "ylabel_db": "dB" in ax.get_ylabel(),
        })
    return out


def _close(got, want, what, db=False):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    if not finite.any():
        return
    if db:
        strong = finite & (want >= want[finite].max() - DB_SPAN)
        np.testing.assert_allclose(got[strong], want[strong], rtol=0, atol=DB_TOL, err_msg=what)
    else:
        np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL,
                                   atol=ATOL_OF_MAX * np.abs(want[finite]).max(), err_msg=what)


def assert_drawings_agree(got, want, what):
    """Two figures' drawings (``drawn``) at the bars of this file."""
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        where = f"{what} axes {k}"
        assert g["texts"] == w["texts"], where
        for part in ("images", "meshes", "lines", "scatters"):
            assert len(g[part]) == len(w[part]), (where, part)
        for (ga, ge), (wa, we) in zip(g["images"], w["images"]):
            _close(ga, wa, where, db=True)  # the floored dB maps
            np.testing.assert_allclose(ge, we, rtol=0, atol=GRID_ATOL, err_msg=where)
        for (ga, gc), (wa, wc) in zip(g["meshes"], w["meshes"]):
            _close(ga, wa, where, db=True)
            np.testing.assert_allclose(gc, wc, rtol=0, atol=GRID_ATOL, err_msg=where)
        for (gx, gy, gl), (wx, wy, wl) in zip(g["lines"], w["lines"]):
            assert gl == wl, where
            if gl.startswith(("est", "estimated", "altitude")) or gl.startswith("_child"):
                np.testing.assert_allclose(gx, wx, rtol=RTOL, atol=1e-4, err_msg=where)
            else:
                np.testing.assert_allclose(gx, wx, rtol=0, atol=GRID_ATOL, err_msg=where)
            _close(gy, wy, f"{where} line {gl}", db=w["ylabel_db"])
        for gs, ws in zip(g["scatters"], w["scatters"]):
            _close(gs, ws, f"{where} scatter")
        np.testing.assert_allclose(g["bars"], w["bars"], rtol=0, atol=GRID_ATOL, err_msg=where)


@pytest.fixture(scope="module")
def frame0(cfgs, datasets):
    """Frame 0 reformatted by each package: a numpy cube (JAX) and a tensor (port)."""
    (jcfg, tcfg), (jds, tds) = cfgs, datasets
    raw = tds.get_radar_adc_data(0)
    return (np.asarray(jproc.VirtualArrayReformatter(jcfg).process(raw)),
            tproc.VirtualArrayReformatter(tcfg, device="cpu").process(raw))


def _plot(name, package, cfg, adc, ax):
    """Draw ``name`` with ``package``'s processors and plotter on ``ax``."""
    port = package == "port"
    p, plot = (tproc, tplot) if port else (jproc, jplot)
    kw = {"device": "cpu"} if port else {}
    plotter = plot.PlotterMmWaveData(cfg)
    if name == "range_doppler":
        proc = p.RangeDopplerProcessor(cfg, **kw)
        plotter.plot_range_doppler_heatmap(proc.process(adc, rx_idx=0), proc, ax=ax)
    elif name in ("range_azimuth_cart", "range_azimuth_polar"):
        proc = p.RangeAngleProcessor(cfg, **kw)
        getattr(plotter, f"plot_{name.replace('azimuth', 'azimuth_heatmap')}")(
            proc.process(adc), proc, ax=ax)
    elif name == "micro_doppler":
        proc = p.MicroDopplerProcessor(cfg, num_frames_history=4, **kw)
        plotter.plot_micro_doppler(proc.process(adc), proc, ax=ax)
    elif name == "doppler_azimuth":
        proc = p.DopplerAzimuthProcessor(cfg, **kw)
        angles = np.asarray(proc.valid_angle_bins)
        peaks = np.array([[angles[len(angles) // 2], 0.3]])
        resp = proc.process(adc)
        gt = 0.3 * np.cos(angles)
        plotter.plot_doppler_azimuth(resp, proc, ax=ax, peaks=torch.from_numpy(peaks) if port
                                     else peaks, vd_ground_truth=gt, vd_estimated=0.9 * gt)
    elif name == "zoomed_doppler_azimuth":
        proc = p.DopplerAzimuthProcessor(cfg, **kw)
        resp, _, _ = proc.process(adc, use_precise_fft=True)
        plotter.plot_zoomed_doppler_azimuth(resp, proc, ax=ax)
    elif name == "range_profile":
        proc = p.RangeProcessor(cfg, **kw)
        prof = proc.process(adc)
        peaks = np.array([0.6, 1.5])
        plotter.plot_range_profile(prof, proc, ax=ax, peaks_m=torch.from_numpy(peaks) if port
                                   else peaks, thresholds=np.abs(to_host(prof)) * 0.5)
    elif name == "raw_adc":
        plotter.plot_raw_adc(adc, ax=ax, rx_idx=2, chirp_idx=5)
    elif name == "altimeter_profiles":
        alt = p.Altimeter(cfg, **ALTIMETER, **kw)
        altitude = float(alt.process(adc))
        plot.PlotterOdometryData(cfg).plot_altimeter_profiles(
            alt.coarse_fft_data, alt.range_bins, altitude_m=altitude, peaks_m=[altitude],
            ax=ax)
    else:
        raise KeyError(name)


PLOTS = ("range_doppler", "range_azimuth_cart", "range_azimuth_polar", "micro_doppler",
         "doppler_azimuth", "zoomed_doppler_azimuth", "range_profile", "raw_adc",
         "altimeter_profiles")


@pytest.mark.parametrize("name", PLOTS)
def test_plotter_draws_what_jax_draws(name, cfgs, frame0):
    """One frame through each package's processors, drawn by each package's plotter."""
    (jcfg, tcfg), (jadc, tadc) = cfgs, frame0
    figs = []
    for package, cfg, adc in (("jax", jcfg, jadc), ("port", tcfg, tadc)):
        fig, ax = plt.subplots()
        _plot(name, package, cfg, adc, ax)
        figs.append(fig)
    try:
        assert_drawings_agree(drawn(figs[1]), drawn(figs[0]), name)
    finally:
        plt.close("all")


def test_zoomed_panel_needs_the_precise_pass(cfgs, frame0):
    proc = tproc.DopplerAzimuthProcessor(cfgs[1], device="cpu")
    with pytest.raises(ValueError, match="use_precise_fft"):
        tplot.PlotterMmWaveData(cfgs[1]).plot_zoomed_doppler_azimuth(proc.process(frame0[1]),
                                                                     proc, ax=plt.subplots()[1])
    plt.close("all")


def test_plotting_aliases_equal_jax():
    assert sorted(tplot.__all__) == sorted(jplot.__all__)
    assert tplot.MovieGeneratorMmWaveData is tplot.MmWaveDataMovieGenerator
    assert tplot.MovieGeneratorOdometry is tplot.OdometryMovieGenerator
    assert tplot.MovieGeneratorSyntheticArrayData is tplot.SyntheticArrayMovieGenerator


# --- movie generators --------------------------------------------------------- #
def _generator(name, package, cfgs, datasets, tmp_path):
    port = package == "port"
    p, plot = (tproc, tplot) if port else (jproc, jplot)
    cfg, ds = (cfgs[1], datasets[1]) if port else (cfgs[0], datasets[0])
    kw = {"device": "cpu"} if port else {}
    common = dict(temp_dir=str(tmp_path / f"{name}_{package}"), fps=5)
    if name == "mmwave":
        procs = {"range_doppler": p.RangeDopplerProcessor(cfg, **kw),
                 "range_angle": p.RangeAngleProcessor(cfg, **kw),
                 "micro_doppler": p.MicroDopplerProcessor(cfg, num_frames_history=4, **kw),
                 "doppler_azimuth": p.DopplerAzimuthProcessor(cfg, **kw),
                 "zoomed_doppler_azimuth": p.DopplerAzimuthProcessor(cfg, **kw)}
        return plot.MmWaveDataMovieGenerator(cfg, ds, plot.PlotterMmWaveData(cfg), procs,
                                             reformatter=p.VirtualArrayReformatter(cfg, **kw),
                                             **common)
    if name == "odometry":
        pcg_params = dict(detector_params=dict(cfar_type="os_cfar_2d", cfar_params=dict(
            num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)))
        if port:
            est = PointsVelocityEstimator(cfg, min_R2_threshold=0.2, min_inlier_percent=0.3,
                                          device="cpu")
            est._draw_scores = JaxKeyStream(42)
        else:
            est = JaxPointsVelocityEstimator(cfg, min_R2_threshold=0.2, min_inlier_percent=0.3)
        return plot.OdometryMovieGenerator(
            cfg, ds, p.Altimeter(cfg, **ALTIMETER, **kw), plot.PlotterOdometryData(cfg),
            reformatter=p.VirtualArrayReformatter(cfg, **kw), velocity_estimator=est,
            point_cloud_generator=p.PointCloudGenerator(cfg, AZ, EL, **pcg_params, **kw),
            **common)
    sa = p.SyntheticArrayBeamformerProcessor(cfg, **SA, **kw)
    return plot.SyntheticArrayMovieGenerator(cfg, ds, sa, plot.PlotterSyntheticArrayData(cfg),
                                             **common)


@pytest.mark.parametrize("name", ["mmwave", "odometry", "synthetic_array"])
def test_movie_generator_writes_the_frames_jax_writes(name, cfgs, datasets, tmp_path):
    """Three frames of each movie from both packages: the frames written and each frame's panels."""
    drawings = {}
    for package in ("jax", "port"):
        gen = _generator(name, package, cfgs, datasets, tmp_path)
        drawings[package] = []
        save = gen.save_frame

        def record(fig, idx, out=drawings[package], save=save):
            out.append(drawn(fig))
            save(fig, idx)
        gen.save_frame = record
        gen.generate_movie_frames(3)
        assert len(gen.frame_paths) == 3 and all(os.path.exists(f) for f in gen.frame_paths)
        written = gen.save_movie(str(tmp_path / f"{name}_{package}.mp4"))
        assert os.path.getsize(written) > 1000
        drawings[package + "_movie"] = os.path.basename(written).split(".")[-1]
    assert drawings["port_movie"] == drawings["jax_movie"]
    for i, (got, want) in enumerate(zip(drawings["port"], drawings["jax"])):
        assert_drawings_agree(got, want, f"{name} frame {i}")
    if name == "synthetic_array":  # frame 0's history fails the gate, frames 1-2 pass
        assert [len(d) for d in drawings["port"]] == [1, 4, 4]


def test_movie_device_half_returns_host_panels(cfgs, datasets, tmp_path):
    """``compute_frame_panels`` returns host arrays: the panels ``generate_movie_frame`` draws."""
    gen = _generator("mmwave", "port", cfgs, datasets, tmp_path)
    panels = gen.compute_frame_panels(0)
    assert set(panels) == {"raw_adc", "range_doppler", "range_angle", "micro_doppler",
                           "doppler_azimuth", "zoomed_doppler_azimuth", "zoomed_vel_bins",
                           "zoomed_vel_valid", "camera"}
    for key, value in panels.items():
        assert value is None or isinstance(value, np.ndarray), key
    assert panels["raw_adc"].shape == (cfgs[1].num_adc_samples,)


# --- AnalysisPlotter -------------------------------------------------------- #
@pytest.fixture(scope="module")
def analyzers():
    gt = np.random.default_rng(0).standard_normal((30, 3))
    est = gt + np.random.default_rng(1).normal(0.0, 0.1, (30, 3))
    out = []
    for cls in (JaxAnalyzer, VelocityAnalyzer):
        an = cls()
        an.analyze(est, gt)
        out.append(an)
    return out


@pytest.mark.parametrize("method", ["plot_summary", "plot_per_axis_histograms",
                                    "plot_error_cdf", "plot_error_histogram",
                                    "plot_error_time_series", "plot_est_vs_gt"])
def test_analysis_plotter_draws_what_jax_draws(analyzers, method):
    """The same errors through both analyzers and plotters: lines within 1e-6, histograms equal."""
    figs = []
    for plotter, an in ((jplot.AnalysisPlotter(), analyzers[0]),
                        (tplot.AnalysisPlotter(), analyzers[1])):
        fn = getattr(plotter, method)
        if method in ("plot_summary", "plot_per_axis_histograms"):
            figs.append(fn(an))
        elif method == "plot_est_vs_gt":
            figs.append(fn(an.get_x_errors() + 1.0, np.ones(30), label="vx").figure)
        else:
            figs.append(fn(an.get_norm_errors()).figure)
    try:
        got, want = drawn(figs[1]), drawn(figs[0])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["texts"] == w["texts"] and len(g["lines"]) == len(w["lines"])
            for (gx, gy, gl), (wx, wy, wl) in zip(g["lines"], w["lines"]):
                assert gl == wl
                np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-6)
                np.testing.assert_allclose(gy, wy, rtol=0, atol=1e-6)
            np.testing.assert_allclose(g["bars"], w["bars"], rtol=0, atol=1e-6)
            for gs, ws in zip(g["scatters"], w["scatters"]):
                np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
    finally:
        plt.close("all")
