"""The port's set-up records (``utils/profiling.SETUP``, ``mmw.setup.*``), on the CPU.

- ``StageTimer`` keeps each name's first seconds beside its totals.
- Each pipeline builder, built and called twice: one first record of
  ``mmw.setup.build.<kind>`` and one of ``mmw.setup.first_call.<kind>``;
  the second call adds nothing and finds no hook (the first call's removed
  themselves); the builders and calls nested inside add no record.  A
  second build adds calls, not a first.
- ``start_cuda`` records ``mmw.setup.cuda_init`` only where CUDA is not yet
  started on a CUDA device.
- ``ops/kernels/_build``: ``load`` records ``mmw.setup.kernel.<name>`` once a
  process, ``build`` records ``mmw.setup.nvcc.<name>`` only when it compiles.
- Under ``profiling.trace`` the set-up spans are user annotations.
- The benchmark's four ``setup.*`` readers: None without records, else the
  sum of the first records of their names.
"""

import ctypes.util
import json
import subprocess

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import (
    build_dbs_pipeline,
    build_full_pipeline,
    build_ground_point_cloud_pipeline,
    build_point_cloud_pipeline,
    build_synthetic_aperture_pipeline,
    build_velocity_analysis_pipeline,
    build_velocity_pipeline,
)
from mmwave_radar_processing_tpu_torch.config import load_cfg
from mmwave_radar_processing_tpu_torch.ops.kernels import _build
from mmwave_radar_processing_tpu_torch.utils import profiling
from mmwave_radar_processing_tpu_torch.utils.profiling import SETUP
from port_bench.lib.harness import metric_modules

torch.set_num_threads(2)  # tier-1 runs several xdist workers

FRAMES = 3
SETUP_METRICS = {"setup.cuda_init_s": ("mmw.setup.cuda_init",),
                 "setup.build_s": ("mmw.setup.build.full", "mmw.setup.build.dbs"),
                 "setup.kernel_load_s": ("mmw.setup.kernel.aoa_head",
                                         "mmw.setup.kernel.os_cfar_detect"),
                 "setup.first_call_s": ("mmw.setup.first_call.full",)}


@pytest.fixture(scope="module")
def cfg(flagship_cfg_path):
    return load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")


@pytest.fixture(scope="module")
def inputs(cfg):
    g = torch.Generator().manual_seed(23)
    shape = (FRAMES, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    re, im = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    return re, im, torch.full((FRAMES,), 1.1)


@pytest.fixture()
def setup_records():
    """An empty ``SETUP``, emptied again after the test."""
    SETUP.reset()
    yield SETUP
    SETUP.reset()


def _build_and_call(cfg, inputs, kind):
    """``(pipeline, function that runs one call of it)`` for builder ``kind``."""
    re, im, alt = inputs
    if kind == "point_cloud":
        pipe = build_point_cloud_pipeline(cfg, device="cpu")
        return pipe, lambda: pipe(re, im)
    if kind == "full":
        pipe = build_full_pipeline(cfg, device="cpu")
        return pipe, lambda: pipe(re, im, alt)
    if kind == "velocity":
        pipe = build_velocity_pipeline(cfg, device="cpu")
        return pipe, lambda: pipe(re, im, alt)
    if kind == "dbs":
        pipe = build_dbs_pipeline(cfg, device="cpu")
        vels = torch.tensor([[0.5, 0.2, 0.0], [0.05, 0.02, 0.0], [0.25, 0.0, 0.0]])
        return pipe, lambda: pipe(re, im, vels)
    if kind == "ground":
        pipe = build_ground_point_cloud_pipeline(cfg, device="cpu")
        return pipe, lambda: pipe(re, im)
    if kind == "velocity_analysis":
        pipe = build_velocity_analysis_pipeline(
            cfg, az_antenna_idxs=(0, 3, 4, 7), el_antenna_idxs=(9, 8, 5, 4),
            vel_cfar_params=dict(num_train=5, num_guard=2, rho=0.6, alpha=4.0),
            min_altitude_m=0.25, zoom_search_region_m=0.2, altitude_search_limit_m=0.4,
            range_bias=0.0, precise_est_enabled=True, max_dets=64, num_angle_bins=64,
            shift_az_resp=True, shift_el_resp=False, min_r2_threshold=0.2,
            min_inlier_percent=0.5, device="cpu")
        scores = torch.randn((FRAMES, 20, 64), generator=torch.Generator().manual_seed(5))
        return pipe, lambda: pipe(re, im, scores=scores)
    assert kind == "synthetic_aperture"
    pipe = build_synthetic_aperture_pipeline(
        cfg, num_frames=2, az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 8)),
        output="depth", device="cpu")
    vels = torch.tensor([[0.2, 0.01, 0.0]] * FRAMES)
    return pipe, lambda: pipe(re, im, vels, pipe.init_state())


def _hooks(module) -> int:
    return len(module._forward_pre_hooks) + len(module._forward_hooks)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for item in tree for leaf in _leaves(item)]


def test_stage_timer_keeps_each_names_first_seconds(setup_records):
    timer = profiling.StageTimer()
    timer.record("load", 0.5)
    timer.record("load", 0.25, items=4)
    timer.record("mmw.setup.first_call.velocity_analysis", 2.0)
    assert timer.first == {"load": 0.5, "mmw.setup.first_call.velocity_analysis": 2.0}
    assert timer.totals["load"] == 0.75 and timer.counts["load"] == 2
    assert timer.items["load"] == 5
    lines = timer.report().splitlines()
    assert lines[0].split()[-1] == "first_s"
    assert lines[1].startswith("mmw.setup.first_call.velocity_analysis ")
    assert lines[1].split()[-1] == "2.000" and lines[2].split()[-1] == "0.500"
    timer.reset()
    assert not timer.first and not timer.totals


@pytest.mark.parametrize("kind", ["point_cloud", "full", "velocity", "dbs", "ground",
                                  "velocity_analysis", "synthetic_aperture"])
def test_a_build_and_two_calls_leave_one_build_and_one_first_call(setup_records, cfg, inputs,
                                                                   kind):
    pipe, call = _build_and_call(cfg, inputs, kind)
    assert dict(setup_records.counts) == {f"mmw.setup.build.{kind}": 1}
    assert _hooks(pipe) == 2
    with torch.no_grad():
        first = call()
        assert _hooks(pipe) == 0  # later calls take the path they took before
        second = call()
    # nested builders and calls record nothing; the CPU starts no CUDA and loads no kernel
    assert dict(setup_records.counts) == {f"mmw.setup.build.{kind}": 1,
                                          f"mmw.setup.first_call.{kind}": 1}
    assert all(s >= 0 for s in setup_records.first.values())
    for a, b in zip(_leaves(first), _leaves(second), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_second_build_adds_calls_not_a_first(setup_records, cfg, inputs):
    re, im, _ = inputs
    with torch.no_grad():
        for _ in range(2):
            build_point_cloud_pipeline(cfg, device="cpu")(re, im)
    first = dict(setup_records.first)
    setup_records.record("mmw.setup.build.point_cloud", 1e3)
    assert setup_records.first == first
    assert setup_records.counts["mmw.setup.build.point_cloud"] == 3
    assert setup_records.counts["mmw.setup.first_call.point_cloud"] == 2


def test_a_first_call_that_raises_is_not_recorded(setup_records, cfg, inputs):
    re, im, _ = inputs
    pipe = build_point_cloud_pipeline(cfg, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError):
        pipe(re[..., :-1], im[..., :-1])
    assert "mmw.setup.first_call.point_cloud" not in setup_records.first
    assert _hooks(pipe) == 2
    with torch.no_grad():
        pipe(re, im)
    assert setup_records.counts["mmw.setup.first_call.point_cloud"] == 1


def test_start_cuda_records_only_a_start(setup_records, monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch, "empty", lambda *a, device: made.append(device))
    profiling.start_cuda("cpu")
    assert not made and not setup_records.counts
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    profiling.start_cuda("cuda:0")
    assert made == [torch.device("cuda", 0)]
    assert dict(setup_records.counts) == {"mmw.setup.cuda_init": 1}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    profiling.start_cuda("cuda")
    assert len(made) == 1 and setup_records.counts["mmw.setup.cuda_init"] == 1


@pytest.fixture()
def fresh_load():
    _build.load.cache_clear()
    yield _build.load
    _build.load.cache_clear()


def test_load_records_each_library_once_a_process(setup_records, fresh_load, monkeypatch):
    libm = ctypes.util.find_library("m")
    assert libm
    built = []
    monkeypatch.setattr(_build, "build", lambda name: built.append(name) or libm)
    monkeypatch.setattr(_build, "find_nvcc", lambda: pytest.fail("nvcc looked for"))
    assert fresh_load("probe") is fresh_load("probe")
    fresh_load("other")
    assert built == ["probe", "other"]
    assert dict(setup_records.counts) == {"mmw.setup.kernel.probe": 1,
                                          "mmw.setup.kernel.other": 1}


def test_build_records_nvcc_only_when_it_compiles(setup_records, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    compiles = []

    def fake_nvcc(cmd, **kwargs):
        compiles.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"library")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    lib = _build.build("altitude_track")
    assert lib.is_file() and lib.parent == tmp_path and len(compiles) == 1
    assert dict(setup_records.counts) == {"mmw.setup.nvcc.altitude_track": 1}
    assert _build.build("altitude_track") == lib  # built: no compile, no record
    assert len(compiles) == 1 and setup_records.counts["mmw.setup.nvcc.altitude_track"] == 1


def test_setup_spans_are_user_annotations_in_the_trace(setup_records, cfg, inputs, tmp_path):
    re, im, _ = inputs
    with profiling.trace(str(tmp_path)), torch.no_grad():
        with profiling.setup_span("probe"):
            pass
        build_point_cloud_pipeline(cfg, device="cpu")(re, im)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"mmw.setup.probe", "mmw.setup.build.point_cloud",
            "mmw.setup.first_call.point_cloud", "mmw.pc"} <= names
    assert set(setup_records.first) == {"mmw.setup.probe", "mmw.setup.build.point_cloud",
                                        "mmw.setup.first_call.point_cloud"}


@pytest.mark.parametrize("metric", sorted(SETUP_METRICS))
def test_setup_reader_sums_the_first_records(setup_records, metric):
    module = metric_modules()[metric]
    assert (module.LAYER, module.UNIT, module.MOVES) == ("set-up", "s", "setup_s")
    assert module.read({}) is None
    others = [n for m, names in SETUP_METRICS.items() if m != metric for n in names]
    for name in others:
        setup_records.record(name, 7.0)
    assert module.read({}) is None
    names = SETUP_METRICS[metric]
    for i, name in enumerate(names):
        setup_records.record(name, 0.5 + i)
        setup_records.record(name, 100.0)  # a second start in the process: not read
    assert module.read({}) == pytest.approx(sum(0.5 + i for i in range(len(names))))
