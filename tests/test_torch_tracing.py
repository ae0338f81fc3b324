"""The program's stage spans (``mmw.*``) in the batched pipelines and the recording feed, on the CPU.

- With no profiler running, ``utils/profiling.annotate`` enters no
  ``record_function``: the spans on the hot path cost a flag check.
- Under ``torch.profiler``, one call of each pipeline (the synthetic
  aperture's streamed, with its depth head) opens each of its stage spans
  once, inside its pipeline's span, and every operator the pipeline runs
  lies in one of its stages, but for the DBS gate's select, which follows
  its three stages inside ``mmw.dbs``.  With more directions than chirps the
  synthetic aperture opens ``mmw.sa.range_dft`` twice: the DFT of each
  frame's chirps, then the magnitude after the product.
- Outputs are bit-identical with the profiler on and off, and each
  ``stop_after`` return closes the spans it leaves.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import (
    build_dbs_pipeline,
    build_full_pipeline,
    build_point_cloud_pipeline,
    build_synthetic_aperture_pipeline,
    build_velocity_pipeline,
)
from mmwave_radar_processing_tpu_torch.config import load_cfg
from mmwave_radar_processing_tpu_torch.parallel.recording import process_recording
from mmwave_radar_processing_tpu_torch.utils import profiling

torch.set_num_threads(2)  # tier-1 runs several xdist workers

FRAMES = 3
PC_STAGES = ("mmw.pc.spectral", "mmw.pc.cfar", "mmw.pc.aoa")
VEL_STAGES = ("mmw.vel.window_dft", "mmw.vel.responses", "mmw.vel.vx", "mmw.vel.peaks",
              "mmw.vel.ransac")
DBS_STAGES = ("mmw.dbs.front", "mmw.dbs.pick", "mmw.dbs.plain")
SA_STAGES = ("mmw.sa.window", "mmw.sa.gate", "mmw.sa.phases", "mmw.sa.product",
             "mmw.sa.range_dft", "mmw.sa.depth")
#: per call: how often each span opens, and the pipeline span each stage lies in
CALLS = {
    "pointcloud": ({"mmw.pc": 1, **dict.fromkeys(PC_STAGES, 1)}, {"mmw.pc": PC_STAGES}),
    "combined": ({"mmw.pc": 1, **dict.fromkeys(PC_STAGES, 1), "mmw.vel": 1,
                  **dict.fromkeys(VEL_STAGES, 1)},
                 {"mmw.pc": PC_STAGES, "mmw.vel": VEL_STAGES}),
    "precise": ({"mmw.vel": 1, **dict.fromkeys(VEL_STAGES, 1), "mmw.vel.responses": 2,
                 "mmw.vel.precise": 1},
                {"mmw.vel": VEL_STAGES + ("mmw.vel.precise",)}),
    "dbs": ({"mmw.dbs": 1, **dict.fromkeys(DBS_STAGES, 1)}, {"mmw.dbs": DBS_STAGES}),
    "sa": ({"mmw.sa": 1, **dict.fromkeys(SA_STAGES, 1)}, {"mmw.sa": SA_STAGES}),
    "sa_dft_first": ({"mmw.sa": 1, **dict.fromkeys(SA_STAGES, 1), "mmw.sa.range_dft": 2},
                     {"mmw.sa": SA_STAGES}),
}
#: pipelines whose own span ends in operators after its last stage: the DBS gate's select
GATED_AFTER_STAGES = ("dbs",)
STOPS = {"responses": ("mmw.vel.window_dft", "mmw.vel.responses"),
         "vx": ("mmw.vel.window_dft", "mmw.vel.responses", "mmw.vel.vx"),
         "peaks": ("mmw.vel.window_dft", "mmw.vel.responses", "mmw.vel.vx", "mmw.vel.peaks")}


@pytest.fixture(scope="module")
def cfg(flagship_cfg_path):
    return load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")


@pytest.fixture(scope="module")
def inputs(cfg):
    g = torch.Generator().manual_seed(17)
    shape = (FRAMES, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    re, im = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    return re, im, torch.full((FRAMES,), 1.1)


def _call(cfg, inputs, kind, **kw):
    """A function that runs one call of pipeline ``kind`` on ``inputs``."""
    re, im, alt = inputs
    if kind == "pointcloud":
        pipe = build_point_cloud_pipeline(cfg, device="cpu")
        return lambda: pipe(re, im)
    if kind == "combined":
        pipe = build_full_pipeline(cfg, device="cpu")
        return lambda: pipe(re, im, alt)
    if kind == "dbs":  # a frame on each side of the gate, and one on it
        pipe = build_dbs_pipeline(cfg, device="cpu")
        vels = torch.tensor([[0.5, 0.2, 0.0], [0.05, 0.02, 0.0], [0.25, 0.0, 0.0]])
        return lambda: pipe(re, im, vels)
    if kind.startswith("sa"):  # the depth head, streamed from the zero state
        # 70 chirps a frame: 8 directions keep the DFT after the element sum, 8 x 10 put it first
        el = np.deg2rad(np.linspace(-15, 15, 10)) if kind == "sa_dft_first" else np.array([0.0])
        pipe = build_synthetic_aperture_pipeline(
            cfg, num_frames=2, az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 8)),
            el_angle_bins_rad=el, output="depth", device="cpu")
        assert pipe.range_dft_first is (kind == "sa_dft_first")
        vels = torch.tensor([[0.2, 0.01, 0.0]] * FRAMES)
        return lambda: pipe(re, im, vels, pipe.init_state())
    pipe = build_velocity_pipeline(cfg, device="cpu", enable_precise=kind == "precise", **kw)
    return lambda: pipe(re, im, alt)


def _profiled(fn):
    """``(fn's result, [(name, start, end)] of every event)`` under ``torch.profiler`` on the CPU."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    return out, events


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for item in tree for leaf in _leaves(item)]


@pytest.fixture(scope="module", params=sorted(CALLS))
def traced(request, cfg, inputs):
    """One call of a pipeline with the profiler off, then one under it."""
    call = _call(cfg, inputs, request.param)
    with torch.no_grad():
        off = call()
        on, events = _profiled(call)
    return request.param, off, on, events


def test_annotate_enters_no_record_function_with_the_profiler_off(monkeypatch, cfg, inputs):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    with pytest.raises(AssertionError, match="profiler off"):
        with torch.profiler.record_function("probe"):
            pass
    assert profiling.annotate("mmw.a") is profiling.annotate("mmw.b")
    with profiling.annotate("mmw.a"):
        pass
    with torch.no_grad():
        _call(cfg, inputs, "combined")()
        _call(cfg, inputs, "dbs")()


def test_the_profiler_flag_flips_under_torch_profiler():
    flag = torch.autograd.profiler
    assert flag._is_profiler_enabled is False
    assert profiling.SPAN_PREFIX == "mmw."
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert flag._is_profiler_enabled is True
        assert isinstance(profiling.annotate("mmw.a"), torch.profiler.record_function)
    assert flag._is_profiler_enabled is False


def test_each_stage_span_opens_once_a_call_inside_its_pipeline_span(traced):
    kind, _, _, events = traced
    counts, stages = CALLS[kind]
    spans = [e for e in events if e[0].startswith(profiling.SPAN_PREFIX)]
    assert Counter(name for name, _, _ in spans) == counts
    for top, names in stages.items():
        (outer,) = [s for s in spans if s[0] == top]
        for span in spans:
            if span[0] in names:
                assert _within(span, outer), (span, outer)


def test_every_operator_of_a_pipeline_lies_in_one_of_its_stages(traced):
    kind, _, _, events = traced
    _, stages = CALLS[kind]
    for top, names in stages.items():
        (outer,) = [e for e in events if e[0] == top]
        inner = [e for e in events if e[0] in names]
        ops = [e for e in events if e[0].startswith("aten::") and _within(e, outer)]
        assert ops
        outside = [op for op in ops if not any(_within(op, stage) for stage in inner)]
        if kind in GATED_AFTER_STAGES:
            assert outside and min(op[1] for op in outside) >= max(s[2] for s in inner)
        else:
            assert not outside, (kind, outside)


def test_outputs_are_bit_identical_with_the_profiler_on_and_off(traced):
    _, off, on, _ = traced
    off, on = _leaves(off), _leaves(on)
    assert len(off) == len(on) > 0
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("stop", sorted(STOPS))
def test_each_stop_after_closes_its_spans(cfg, inputs, stop):
    call = _call(cfg, inputs, "coarse", stop_after=stop)

    def call_then_span():
        out = call()
        with profiling.annotate("mmw.after"):
            torch.ones(2).sum()
        return out

    with torch.no_grad():
        _, events = _profiled(call_then_span)
    spans = [e for e in events if e[0].startswith(profiling.SPAN_PREFIX)]
    assert Counter(name for name, _, _ in spans) == Counter(("mmw.vel", "mmw.after") + STOPS[stop])
    (outer,) = [s for s in spans if s[0] == "mmw.vel"]
    (after,) = [s for s in spans if s[0] == "mmw.after"]
    assert after[1] >= outer[2]
    assert all(_within(s, outer) for s in spans if s[0] in STOPS[stop])


def test_the_recording_feed_names_its_waits(cfg, inputs, tmp_path):
    re, im, _ = inputs
    paths = []
    for i in range(FRAMES):
        path = tmp_path / f"frame_{i}.npy"
        np.save(path, (re[i] + 1j * im[i]).numpy().astype(np.complex64))
        paths.append(str(path))
    with torch.no_grad():
        out, events = _profiled(lambda: process_recording(
            paths, cfg, mode="points", batch=2, loader_threads=1, device="cpu",
            backend="numpy"))
    assert out["points"].shape[0] == FRAMES
    names = Counter(e[0] for e in events if e[0].startswith("mmw."))
    # two batches and the wait that finds the loader exhausted; no copy on the CPU
    assert names["mmw.feed.load_wait"] == 3 and names["mmw.pc"] == 2
    assert "mmw.feed.h2d" not in names
