"""The stage readers: device operations tied to the program's ``mmw.*`` spans through their launches.

Hand-built Chrome events: kernels and copies with a ``correlation``, the
runtime and driver calls that launched them, and nested spans on two host
threads.  Then the replayed window of a tiny cell on the CPU, which finds
the spans and, with no device, no stage time.
"""

import pytest

from port_bench.lib import stages as st
from port_bench.lib.harness import Cell, metric_modules
from port_bench.lib.trace import Trace

STAGE_METRICS = {
    "vel.window_dft.ms_per_kframe": "mmw.vel.window_dft",
    "vel.vx.ms_per_kframe": "mmw.vel.vx",
    "vel.peaks.ms_per_kframe": "mmw.vel.peaks",
    "vel.ransac.ms_per_kframe": "mmw.vel.ransac",
    "pc.spectral.ms_per_kframe": "mmw.pc.spectral",
    "pc.aoa.ms_per_kframe": "mmw.pc.aoa",
}


def span(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def launch(corr, ts, tid=1, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"cat": cat, "name": name, "ts": ts, "dur": 2, "tid": tid,
            "args": {"correlation": corr}}


def device(corr, dur, name="kernel_a", cat="kernel", ts=1000):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


EVENTS = [
    # thread 1: mmw.vel [0, 100) holding window_dft [0, 30), and precise [40, 90)
    # that holds a nested responses [50, 70); a pb.* span around all
    span("pb.pipeline", 0, 200), span("mmw.vel", 0, 100), span("mmw.vel.window_dft", 0, 30),
    span("mmw.vel.precise", 40, 50), span("mmw.vel.responses", 50, 20),
    launch(1, 10), launch(2, 45), launch(3, 55, cat="cuda_driver", name="cuLaunchKernelEx"),
    launch(4, 75), launch(5, 95), launch(6, 150, name="cudaMemcpyAsync"),
    # thread 2: its own span; a launch on thread 1 at that time is not in it
    span("mmw.pc.aoa", 0, 300, tid=2), launch(7, 20, tid=2, name="cudaMemsetAsync"),
    launch(8, 260),
    device(1, 100), device(2, 200), device(3, 300), device(4, 400), device(5, 500),
    device(6, 600, cat="gpu_memcpy", name="Memcpy DtoH"), device(7, 700, cat="gpu_memset"),
    device(8, 800), device(9, 900),  # 9: no launch record
    {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 199, "dur": 1, "tid": 1},
]
STAGE = {1: "mmw.vel.window_dft", 2: "mmw.vel.precise", 3: "mmw.vel.responses",
         4: "mmw.vel.precise", 5: "mmw.vel", 6: None, 7: "mmw.pc.aoa", 8: None, 9: None}


@pytest.fixture()
def stages():
    return st.Stages.from_events(EVENTS, frames=2048)


def test_each_operation_belongs_to_the_innermost_span_open_at_its_launch(stages):
    assert {op[3]: stages.stage_of(op) for op in stages.device_ops} == STAGE
    assert set(stages.spans) == {1, 2}
    assert all(not name.startswith("pb.") for spans in stages.spans.values()
               for name, _, _ in spans)


def test_a_nested_span_takes_its_own_time(stages):
    assert stages.stage_seconds("mmw.vel.precise") == pytest.approx(600e-6)
    assert stages.stage_seconds("mmw.vel.responses") == pytest.approx(300e-6)
    assert stages.stage_seconds("mmw.vel") == pytest.approx(500e-6)
    assert stages.stage_seconds("mmw.vel.ransac") == 0.0


def test_attributed_and_unattributed_time_add_up_to_every_operation(stages):
    by_stage = stages.seconds_by_stage()
    assert by_stage[None] == pytest.approx((600 + 800 + 900) * 1e-6)
    assert sum(by_stage.values()) == pytest.approx(sum(op[2] for op in stages.device_ops) / 1e6)


def test_launches_count_every_device_operation_inside_a_call(stages):
    # one call of mmw.vel (ops 1-5) and one of mmw.pc.aoa on thread 2 (op 7)
    assert stages.call_launches() == 6
    assert {tid: span[0] for tid, span in stages.call_by_correlation.values()} == {
        1: "mmw.vel", 2: "mmw.pc.aoa"}


def test_each_call_counts_as_the_most_common_call_of_its_kind():
    """Three calls of ``mmw.pc``, the first short of one operation (an event the profiler lost)."""
    events = []
    for call, n_ops in enumerate((2, 3, 3)):
        t0 = 100 * call
        events += [span("mmw.pc", t0, 50), span("mmw.pc.spectral", t0, 40)]
        for k in range(n_ops):
            corr = 10 * call + k
            events += [launch(corr, t0 + 1 + k), device(corr, 5)]
    stages = st.Stages.from_events(events, frames=3 * 1024)
    assert len(stages.device_ops) == 8 and stages.call_launches() == 9
    assert metric_modules()["launches_per_kframe"].read({"stages": stages}) == 3.0


@pytest.mark.parametrize("spans,points,want", [
    ([("a", 0, 30), ("b", 0, 20)], [(5, 1)], {1: ("b", "a")}),  # equal starts: b inside a
    ([("a", 0, 30), ("b", 0, 20)], [(25, 1), (35, 2)], {1: ("a", "a"), 2: None}),
    ([("b", 5, 10), ("a", 0, 30), ("c", 12, 20)], [(11, 1), (15, 2)],
     {1: ("a", "a"), 2: ("c", "a")}),
    ([], [(1, 1)], {1: None}),
])
def test_enclosing_sweeps_nested_spans(spans, points, want):
    found = st.enclosing(spans, points)
    assert {k: v and (v[0][0], v[1][0]) for k, v in found.items()} == want


def test_readers_read_the_stages(stages):
    modules = metric_modules()
    ctx = {"stages": stages}
    assert modules["launches_per_kframe"].read(ctx) == 6 * 1024 / 2048
    for name, module in modules.items():
        if name in STAGE_METRICS:
            expected = stages.stage_seconds(STAGE_METRICS[name]) * 1e3 * 1024 / 2048
            assert module.read(ctx) == (pytest.approx(expected) if expected else None), name


def test_each_reader_gives_none_where_its_span_never_appeared():
    bare = st.Stages.from_events([e for e in EVENTS if e.get("cat") != "user_annotation"],
                                 frames=2048)
    ctx = {"stages": bare}
    modules = metric_modules()
    for name in [*STAGE_METRICS, "launches_per_kframe"]:
        assert modules[name].read(ctx) is None, name


@pytest.mark.parametrize("cell,spans", [
    ("tiny-ods20-combined-bulk", {"mmw.pc", "mmw.pc.spectral", "mmw.pc.cfar", "mmw.pc.aoa",
                                  "mmw.vel", "mmw.vel.window_dft", "mmw.vel.responses",
                                  "mmw.vel.vx", "mmw.vel.peaks", "mmw.vel.ransac"}),
    ("tiny-ods10-pointcloud-bulk", {"mmw.pc", "mmw.pc.spectral", "mmw.pc.cfar", "mmw.pc.aoa"}),
])
def test_the_replayed_window_finds_the_program_spans(bench_copy, cell, spans):
    """On the CPU the replay sees the spans but no device, so every stage reader gives None."""
    ctx = {"cell": Cell.load(cell, bench_copy), "trace": Trace(window_s=0.05, frames=0)}
    found = st.stages(ctx)
    assert st.stages(ctx) is found  # replayed once a run
    assert {name for thread in found.spans.values() for name, _, _ in thread} == spans
    assert found.frames > 0 and not found.device_ops
    modules = metric_modules()
    for name in [*STAGE_METRICS, "launches_per_kframe"]:
        assert modules[name].read(ctx) is None, name
