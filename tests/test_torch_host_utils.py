"""The port's host layer of the recording path against the JAX package on the CPU.

- the NPY loader (``data.native_loader``): the native library, built with
  ``g++`` into ``build/torch_native/``, bit-equal to its ``backend="numpy"``
  reader on complex64, complex128, float32 and float64 frames, both raising
  on a malformed file; the prefetcher's order with its two reused slots and
  its wait on a slot's release event; two processes building at once; a
  failed build raises; ``native/`` is left as it was;
- ``CpslDS`` / ``write_dataset``, ``utils.rotations``, ``utils.env``,
  ``utils.logger``: equal to the JAX package's copies;
- checkpoints: a file written by the JAX ``save_state`` from JAX states loads
  through the port's ``load_state`` into equal port states and the reverse,
  on a dict whose insertion order is not its sorted order (leaves are numbered
  in sorted key order in both); ``PipelineCheckpointer``'s cadence and resume;
- ``StageTimer`` counts, ``fence``, ``trace`` and ``annotate`` on the CPU;
- ``VelocityAnalyzer``'s report equal to the JAX package's, value for value;
- the per-frame velocity-analysis flow (``analysis.analyze_velocity``, the
  loop of ``scripts/torch_test_vel_estimation.py``) equal to the JAX
  script's flow on 12 frames of a simulated recording, with the JAX key
  stream's draws handed in: estimates within 1e-4.
"""

import hashlib
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from mmwave_radar_processing_tpu.analysis import VelocityAnalyzer as JaxVelocityAnalyzer
from mmwave_radar_processing_tpu.config import load_cfg as jax_load_cfg
from mmwave_radar_processing_tpu.data import cpsl_dataset as jax_cpsl
from mmwave_radar_processing_tpu.point_cloud_processing import (
    VelocityEstimator as JaxPointsVE,
)
from mmwave_radar_processing_tpu.processors.altimeter import Altimeter as JaxAltimeter
from mmwave_radar_processing_tpu.processors.micro_doppler import (
    MicroDopplerProcessor as JaxMicroDoppler,
)
from mmwave_radar_processing_tpu.processors.point_cloud import (
    PointCloudGenerator as JaxPointCloudGenerator,
)
from mmwave_radar_processing_tpu.processors.synthetic_array import (
    SyntheticArrayBeamformerProcessor as JaxSA,
)
from mmwave_radar_processing_tpu.processors.virtual_array import (
    VirtualArrayReformatter as JaxReformatter,
)
from mmwave_radar_processing_tpu.utils import checkpoint as jax_checkpoint
from mmwave_radar_processing_tpu.utils import env as jax_env
from mmwave_radar_processing_tpu.utils import rotations as jax_rotations
from mmwave_radar_processing_tpu_torch import load_cfg
from mmwave_radar_processing_tpu_torch.analysis import (
    VelocityAnalyzer,
    analyze_velocity,
    build_estimator,
)
from mmwave_radar_processing_tpu_torch.data import (
    CpslDS,
    ground_scene,
    make_odom_rows,
    simulate_frame,
    write_dataset,
)
from mmwave_radar_processing_tpu_torch.data import native_loader
from mmwave_radar_processing_tpu_torch.processors import (
    Altimeter,
    MicroDopplerProcessor,
    SyntheticArrayBeamformerProcessor,
)
from mmwave_radar_processing_tpu_torch.utils import checkpoint, env, logger, profiling, rotations
from test_torch_velocity_estimator import JaxKeyStream

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_SHAPE = (4, 63, 210)
VELOCITY_ATOL = 1e-4
FLOW_FRAMES = 12


# --------------------------------------------------------------------------- #
# the NPY loader
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def frame_files(tmp_path_factory):
    """12 frames alternating complex64 / complex128 (the cases of ``test_native_loader.py``)."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        arr = (rng.standard_normal(FRAME_SHAPE) + 1j * rng.standard_normal(FRAME_SHAPE)).astype(
            np.complex64 if i % 2 == 0 else np.complex128)
        path = str(root / f"frame_{i:03d}.npy")
        np.save(path, arr)
        paths.append(path)
    return paths


def _both_backends(paths, shape, **kw):
    native = native_loader.load_frames_split(paths, shape, **kw)
    plain = native_loader.load_frames_split(paths, shape, backend="numpy")
    return native, plain


def test_native_loader_builds_into_the_build_tree():
    lib = native_loader.build()
    assert lib.parent == native_loader.BUILD_DIR
    assert native_loader.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    assert lib.name.startswith("libnpy_loader-") and lib.is_file()
    assert native_loader.library_path() == lib  # keyed on source and flags: reused


@pytest.mark.parametrize("nthreads", [1, 4])
def test_native_equals_numpy_reader_on_complex_frames(frame_files, nthreads):
    (re_n, im_n), (re_p, im_p) = _both_backends(frame_files, FRAME_SHAPE, nthreads=nthreads)
    assert re_n.shape == (12, *FRAME_SHAPE) and re_n.dtype == torch.float32
    assert torch.equal(re_n, re_p) and torch.equal(im_n, im_p)
    for i, path in enumerate(frame_files):
        arr = np.load(path)
        np.testing.assert_array_equal(re_p[i].numpy(), np.real(arr).astype(np.float32))
        np.testing.assert_array_equal(im_p[i].numpy(), np.imag(arr).astype(np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_equals_numpy_reader_on_real_frames(tmp_path, dtype):
    shape = (8, 16)
    arr = np.random.default_rng(1).standard_normal((3, *shape)).astype(dtype) * 1e3
    paths = []
    for i, frame in enumerate(arr):
        paths.append(str(tmp_path / f"real_{i}.npy"))
        np.save(paths[-1], frame)
    (re_n, im_n), (re_p, im_p) = _both_backends(paths, shape)
    assert torch.equal(re_n, re_p) and torch.equal(im_n, im_p)
    np.testing.assert_array_equal(re_n.numpy(), arr.astype(np.float32))
    assert not im_n.any()


def test_npy_info(frame_files):
    assert native_loader.npy_info(frame_files[0]) == (FRAME_SHAPE, 1)
    assert native_loader.npy_info(frame_files[1]) == (FRAME_SHAPE, 2)


@pytest.mark.parametrize("backend", native_loader.BACKENDS)
@pytest.mark.parametrize("case", ["garbage", "missing", "other_size", "int16"])
def test_malformed_file_raises(tmp_path, frame_files, backend, case):
    bad = str(tmp_path / "bad.npy")
    if case == "garbage":
        with open(bad, "wb") as fh:
            fh.write(b"not an npy file at all")
    elif case == "other_size":
        np.save(bad, np.zeros((4, 63, 200), np.complex64))
    elif case == "int16":
        np.save(bad, np.zeros(FRAME_SHAPE, np.int16))
    with pytest.raises(IOError):
        native_loader.load_frames_split([frame_files[0], bad], FRAME_SHAPE, backend=backend)


def test_loader_fills_the_callers_buffers(frame_files):
    out = tuple(torch.full((3, *FRAME_SHAPE), 7.0) for _ in range(2))
    ptrs = [t.data_ptr() for t in out]
    re, im = native_loader.load_frames_split(frame_files[:3], FRAME_SHAPE, out=out)
    assert [re.data_ptr(), im.data_ptr()] == ptrs
    want = native_loader.load_frames_split(frame_files[:3], FRAME_SHAPE, backend="numpy")
    assert torch.equal(re, want[0]) and torch.equal(im, want[1])
    with pytest.raises(ValueError):
        native_loader.load_frames_split(frame_files[:2], FRAME_SHAPE, out=out)
    with pytest.raises(ValueError):
        native_loader.load_frames_split(frame_files[:3], FRAME_SHAPE,
                                        out=(out[0].double(), out[1]))
    with pytest.raises(ValueError):
        native_loader.load_frames_split(frame_files[:3], FRAME_SHAPE, backend="mmap")


@pytest.mark.parametrize("backend", native_loader.BACKENDS)
def test_prefetcher_order_with_reused_slots(frame_files, backend):
    fetcher = native_loader.SplitFramePrefetcher(frame_files, FRAME_SHAPE, batch=5, nthreads=2,
                                                 backend=backend)
    sizes, ptrs, planes = [], [], []
    for re, im in fetcher:
        sizes.append(re.shape[0])
        ptrs.append((re.data_ptr(), im.data_ptr()))
        planes.append((re.clone(), im.clone()))  # the slot is refilled later
    assert sizes == [5, 5, 2]
    assert ptrs[0] == ptrs[2] and ptrs[0] != ptrs[1]  # two slots, taken in turns
    want = native_loader.load_frames_split(frame_files, FRAME_SHAPE, backend="numpy")
    assert torch.equal(torch.cat([p[0] for p in planes]), want[0])
    assert torch.equal(torch.cat([p[1] for p in planes]), want[1])
    assert len(fetcher.load_seconds) == 3
    assert list(native_loader.SplitFramePrefetcher([], FRAME_SHAPE, batch=5)) == []


class _SlowEvent:
    """Stands in for a CUDA event behind a copy: completes ``delay`` seconds after it is waited on."""

    def __init__(self, delay, log):
        self.delay, self.log = delay, log

    def synchronize(self):
        time.sleep(self.delay)
        self.log.append(("event", time.perf_counter()))


def test_prefetcher_refills_a_slot_only_after_its_release_event(frame_files):
    log = []
    fetcher = native_loader.SplitFramePrefetcher(frame_files, FRAME_SHAPE, batch=4, nthreads=1)
    original_fill = fetcher._fill

    def fill(chunk, slot):
        out = original_fill(chunk, slot)
        log.append(("filled", slot, time.perf_counter()))
        return out

    fetcher._fill = fill
    seen = []
    for k, (re, _) in enumerate(fetcher):
        seen.append(re[:, 0, 0, 0].clone())
        snapshot = re.clone()
        fetcher.release(_SlowEvent(0.05, log))
        if k == 0:
            time.sleep(0.01)
        assert torch.equal(re, snapshot)  # not overwritten while its event is pending
    events = [t for kind, *rest in log if kind == "event" for t in rest]
    third_fill = [rest for kind, *rest in log if kind == "filled"][2]
    assert third_fill[0] == 0 and events and events[0] <= third_fill[1]
    with pytest.raises(RuntimeError):
        native_loader.SplitFramePrefetcher(frame_files, FRAME_SHAPE).release(None)


_BUILD_AND_LOAD = """
import sys
from pathlib import Path
import numpy as np
import mmwave_radar_processing_tpu_torch.data.native_loader as nl
nl.BUILD_DIR = Path(sys.argv[1])
lib = nl.build()
re, im = nl.load_frames_split(sys.argv[2:], (4, 63, 210), 2)
plain = nl.load_frames_split(sys.argv[2:], (4, 63, 210), backend="numpy")
assert (re == plain[0]).all() and (im == plain[1]).all()
print(lib.name)
"""


def test_two_processes_build_the_loader_at_once(tmp_path, frame_files):
    build_dir = tmp_path / "torch_native"
    env_vars = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(build_dir),
                               *frame_files[:4]], cwd=REPO, env=env_vars,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-2000:]
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(names)  # no temporaries left


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native_loader, "GXX_FLAGS", (*native_loader.GXX_FLAGS,
                                                     "-fno-such-flag-anywhere"))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*no-such-flag"):
        native_loader.build()
    assert not any((tmp_path / "torch_native").iterdir())


def test_the_repositorys_native_directory_is_left_alone(frame_files):
    native_dir = os.path.join(REPO, "native")

    def digest():
        return {name: hashlib.sha256(open(os.path.join(native_dir, name), "rb").read())
                .hexdigest() for name in sorted(os.listdir(native_dir))}

    before = digest()
    native_loader.load_frames_split(frame_files[:2], FRAME_SHAPE)
    assert digest() == before
    assert native_loader.SOURCE == native_loader.REPO_ROOT / "native" / "npy_loader.cpp"
    assert "native" not in native_loader.library_path().parent.parts[-2:]


# --------------------------------------------------------------------------- #
# copies of numpy-only modules
# --------------------------------------------------------------------------- #
def test_cpsl_dataset_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    adc = (rng.standard_normal((3, 4, 6, 5)) + 1j * rng.standard_normal((3, 4, 6, 5))
           ).astype(np.complex64)
    odom = np.stack([make_odom_rows(v) for v in rng.standard_normal((3, 3))])
    extra = dict(vel=rng.standard_normal((3, 2, 3)), hand_tracking=rng.standard_normal((3, 5, 3)),
                 imu_orientation=rng.standard_normal((3, 4)), imu_full=rng.standard_normal((3, 6)),
                 radar_pc=[rng.standard_normal((n, 4)) for n in (2, 0, 5)])
    write_dataset(str(tmp_path / "port"), adc, odom=odom, **extra)
    jax_cpsl.write_dataset(str(tmp_path / "jax"), adc, odom=odom, **extra)
    for sub in sorted(os.listdir(tmp_path / "jax")):
        for name in sorted(os.listdir(tmp_path / "jax" / sub)):
            a = (tmp_path / "jax" / sub / name).read_bytes()
            assert (tmp_path / "port" / sub / name).read_bytes() == a, (sub, name)
    np.testing.assert_array_equal(make_odom_rows([1, 2, 3], rows=2),
                                  jax_cpsl.make_odom_rows([1, 2, 3], rows=2))
    port = CpslDS(str(tmp_path / "port"), radar_pc_folder="radar_0_pc")
    ref = jax_cpsl.CpslDS(str(tmp_path / "port"), radar_pc_folder="radar_0_pc")
    assert port.num_frames == ref.num_frames == 3
    for flag in ("radar_enabled", "radar_pc_enabled", "lidar_enabled", "camera_enabled",
                 "vehicle_odom_enabled", "hand_tracking_enabled", "imu_full_enabled"):
        assert getattr(port, flag) == getattr(ref, flag), flag
    for getter in ("get_radar_adc_data", "get_radar_data", "get_vehicle_odom_data",
                   "get_vehicle_vel_data", "get_hand_tracking_data",
                   "get_imu_orientation_data", "get_imu_full_data", "get_radar_point_cloud"):
        for i in range(3):
            np.testing.assert_array_equal(getattr(port, getter)(i), getattr(ref, getter)(i))


def test_rotations_equal_jax():
    rng = np.random.default_rng(5)
    angles, pts = rng.uniform(-4, 4, 6), rng.standard_normal((6, 2))
    trans = rng.standard_normal((6, 2))
    for name, args in [("get_rot_matrix", (0.7,)), ("get_rot_matrices", (angles,)),
                       ("apply_rot_trans", (pts, 0.3, trans[0])),
                       ("apply_multiple_rot_trans", (pts, angles, trans)),
                       ("apply_unique_rot_trans_to_multiple_points", (pts, angles, trans)),
                       ("wrap_heading", (angles,))]:
        np.testing.assert_array_equal(getattr(rotations, name)(*args),
                                      getattr(jax_rotations, name)(*args))
    m = rotations.get_rot_matrix(1.1)
    assert rotations.get_angle_from_rot_matrix(m) == jax_rotations.get_angle_from_rot_matrix(m)


def test_env_equals_jax(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text("# roots\nDATASET_DIRECTORY=/data/sets\n"
                                   "CONFIG_DIRECTORY='/data/cfgs'\nnot a pair\n")
    (tmp_path / "sub").mkdir()
    monkeypatch.chdir(tmp_path / "sub")
    assert env.KEYS == jax_env.KEYS
    assert env.find_env_file() == jax_env.find_env_file() == str(tmp_path / ".env")
    try:
        assert env.load_env() == jax_env.load_env() == {
            "DATASET_DIRECTORY": "/data/sets", "CONFIG_DIRECTORY": "/data/cfgs"}
        for path in ("rec1", "/abs/x"):
            assert env.resolve_dir(path, "DATASET_DIRECTORY") == \
                jax_env.resolve_dir(path, "DATASET_DIRECTORY")
        assert env.resolve_dir("rec1", "DATASET_DIRECTORY") == "/data/sets/rec1"
    finally:
        for key in ("DATASET_DIRECTORY", "CONFIG_DIRECTORY"):
            os.environ.pop(key, None)


def test_logger_names_the_port():
    log = logger.setup_logger(level=logging.INFO, set_default=False)
    assert log.name == "mmwave_radar_processing_tpu_torch" and not log.propagate
    assert len(log.handlers) == 1
    assert logger.get_logger("mmwave_radar_processing_tpu_torch.x").hasHandlers()


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def _states(seed, md, alt, sa, to_state):
    """A dict whose insertion order is not sorted, two leaves of one shape under two keys."""
    rng = np.random.default_rng(seed)
    md_shape = tuple(np.shape(md.init_state()))
    sa_state = sa.init_state()
    adc_shape = tuple(sa_state.adc_history.shape)
    return {
        "sa": to_state("sa", (rng.standard_normal(adc_shape)
                              + 1j * rng.standard_normal(adc_shape)).astype(np.complex64),
                       rng.standard_normal((adc_shape[0], 3)).astype(np.float32)),
        "md_b": to_state("md", rng.standard_normal(md_shape).astype(np.float32)),
        "alt": to_state("alt", np.float32(rng.uniform(0.3, 1.5))),
        "md_a": to_state("md", rng.standard_normal(md_shape).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def processors(flagship_cfg_path):
    cfg = load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")
    jcfg = jax_load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")
    alt_kw = dict(min_altitude_m=0.25, zoom_search_region_m=0.2, altitude_search_limit_m=0.4)
    port = (MicroDopplerProcessor(cfg, num_frames_history=5, device="cpu"),
            Altimeter(cfg, **alt_kw, device="cpu"),
            SyntheticArrayBeamformerProcessor(cfg, num_frames=2, device="cpu"))
    ref = (JaxMicroDoppler(jcfg, num_frames_history=5), JaxAltimeter(jcfg, **alt_kw),
           JaxSA(jcfg, num_frames=2))
    return port, ref


def _port_state(port):
    md, alt, sa = port

    def make(kind, *arrays):
        if kind == "md":
            return md.state_from_jax(arrays[0])
        if kind == "alt":
            return alt.init_state(arrays[0])
        return sa.state_from_jax(*arrays)
    return make


def _jax_state(ref):
    from mmwave_radar_processing_tpu.processors.altimeter import AltimeterState
    from mmwave_radar_processing_tpu.processors.synthetic_array import SyntheticArrayState

    def make(kind, *arrays):
        if kind == "md":
            return arrays[0]
        if kind == "alt":
            return AltimeterState(arrays[0])
        return SyntheticArrayState(*arrays)
    return make


def _like(procs):
    md, alt, sa = procs
    return {"sa": sa.init_state(), "md_b": md.init_state(), "alt": alt.init_state(),
            "md_a": md.init_state()}


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)  # jax.tree.unflatten rebuilds a dict in sorted order
    for key in want:
        got_leaves = checkpoint.flatten(got[key])
        want_leaves = checkpoint.flatten(want[key])
        assert len(got_leaves) == len(want_leaves), key
        for g, w in zip(got_leaves, want_leaves):
            g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_jax_checkpoint_loads_into_port_states(tmp_path, processors):
    port, ref = processors
    path = str(tmp_path / "jax_state.npz")
    jax_states = _states(0, *ref, _jax_state(ref))
    jax_checkpoint.save_state(path, jax_states, metadata={"frame_idx": 42})
    restored, meta = checkpoint.load_state(path, _like(port))
    assert meta == {"frame_idx": 42}
    _assert_states_equal(restored, _states(0, *port, _port_state(port)))
    assert type(restored["alt"]).__name__ == "AltimeterState"
    assert restored["sa"].adc_history.dtype == torch.complex64


def test_port_checkpoint_loads_into_jax_states(tmp_path, processors):
    port, ref = processors
    path = str(tmp_path / "port_state.npz")
    checkpoint.save_state(path, _states(1, *port, _port_state(port)), metadata={"frame_idx": 7})
    restored, meta = jax_checkpoint.load_state(path, _like(ref))
    assert meta == {"frame_idx": 7}
    _assert_states_equal(restored, _states(1, *ref, _jax_state(ref)))


def test_leaves_are_numbered_in_sorted_key_order(tmp_path, processors):
    port, _ = processors
    states = _states(2, *port, _port_state(port))
    leaves = checkpoint.flatten(states)
    assert [id(x) for x in leaves] == [id(x) for x in (
        states["alt"].altitude_measured_m, states["md_a"], states["md_b"],
        states["sa"].adc_history, states["sa"].vel_history)]
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, states)
    with np.load(path) as data:
        np.testing.assert_array_equal(data["leaf1"], states["md_a"].numpy())
        assert {"leaf3::re", "leaf3::im", "__treedef__"} <= set(data.files)
        assert "__metadata__" not in data.files


def test_load_state_restores_device_dtype_and_checks_shapes(tmp_path):
    state = {"final_altitude": torch.tensor(0.8125), "history": [torch.arange(4.0), None],
             "steps": np.int64(3)}
    path = str(tmp_path / "ground.npz")
    checkpoint.save_state(path, state)
    like = {"final_altitude": torch.tensor(0.0, dtype=torch.float64),
            "history": [torch.zeros(4), None], "steps": np.int64(0)}
    got, meta = checkpoint.load_state(path, like)
    assert meta is None and got["history"][1] is None
    assert got["final_altitude"].dtype == torch.float64 and float(got["final_altitude"]) == 0.8125
    assert torch.equal(got["history"][0], torch.arange(4.0)) and got["steps"] == 3
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_state(path, {**like, "history": [torch.zeros(5), None]})


def test_pipeline_checkpointer_cadence_and_resume(tmp_path, processors):
    port, _ = processors
    alt = port[1]
    cp = checkpoint.PipelineCheckpointer(str(tmp_path / "ckpt"), every_n_frames=10)
    states = {"altimeter": alt.init_state(1.23)}
    assert not cp.maybe_save(0, states)
    assert not cp.maybe_save(5, states)
    assert cp.maybe_save(10, states)
    assert cp.maybe_save(20, {"altimeter": alt.init_state(0.5)})
    restored, frame = cp.restore({"altimeter": alt.init_state()})
    assert frame == 20 and float(restored["altimeter"].altitude_measured_m) == 0.5
    like = {"altimeter": alt.init_state()}
    passthrough, frame = checkpoint.PipelineCheckpointer(str(tmp_path / "empty")).restore(like)
    assert frame == 0 and passthrough is like


# --------------------------------------------------------------------------- #
# timing, tracing, analyzers
# --------------------------------------------------------------------------- #
def test_stage_timer_counts():
    timer = profiling.StageTimer()
    with timer.stage("fft", items=64) as sink:
        sink(torch.ones(8))
    with timer.stage("fft", items=64) as sink:
        sink(torch.ones(8))
    with timer.stage("cfar", items=64, block_on=[torch.ones(2)]) as sink:
        sink(None)
    timer.record("load", 0.25, items=16)
    report = timer.report()
    assert "fft" in report and "cfar" in report and "load" in report
    assert timer.counts["fft"] == 2 and timer.items["fft"] == 128
    assert timer.totals["load"] == 0.25 and timer.items["load"] == 16
    timer.reset()
    assert not timer.totals and not timer.counts and not timer.items


def test_fence_returns_at_once_on_the_cpu():
    profiling.fence({"a": torch.ones(3), "b": [np.ones(2), None, 1.0]})
    profiling.fence(None)


def test_trace_and_annotate_write_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("stage_x"):
            torch.ones(64).sum()
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "stage_x" in text


@pytest.mark.parametrize("method", ["signed", "absolute"])
def test_velocity_analyzer_report_equals_jax(method):
    rng = np.random.default_rng(6)
    est, gt = rng.standard_normal((40, 3)), rng.standard_normal((40, 3))
    port, ref = VelocityAnalyzer(), JaxVelocityAnalyzer()
    port.analyze(est, gt, error_method=method)
    ref.analyze(est, gt, error_method=method)
    got, want = port.generate_report(), ref.generate_report()
    assert list(got.index) == list(want.index) == ["X", "Y", "Z", "Norm"]
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got.values, want.values)
    for name in ("x", "y", "z", "norm"):
        np.testing.assert_array_equal(getattr(port, f"get_{name}_errors")(),
                                      getattr(ref, f"get_{name}_errors")())


def test_velocity_analyzer_errors_as_jax():
    port, ref = VelocityAnalyzer(), JaxVelocityAnalyzer()
    for analyzer in (port, ref):
        with pytest.raises(ValueError, match="Call analyze"):
            analyzer.get_x_errors()
        with pytest.raises(ValueError, match="Shape mismatch"):
            analyzer.analyze(np.zeros((3, 3)), np.zeros((4, 3)))
        with pytest.raises(ValueError, match="3D"):
            analyzer.analyze(np.zeros((3, 2)), np.zeros((3, 2)))
        with pytest.raises(ValueError, match="Unknown"):
            analyzer.compute_error(np.zeros(2), np.zeros(2), "squared")
    assert port.compute_summary_statistics(np.array([])) == \
        ref.compute_summary_statistics(np.array([]))


# --------------------------------------------------------------------------- #
# the velocity-analysis flow
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def flow_recording(tmp_path_factory, flagship_cfg_path):
    """12 ground frames at a gradual altitude, the odometry's velocity beside them."""
    cfg = load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")
    rng = np.random.default_rng(3)
    ego = np.array([0.8, 0.3, -0.1])
    frames = []
    for i in range(FLOW_FRAMES):
        alt = 0.6 + 0.06 * i
        scene = ground_scene(cfg, altitude_m=alt, ego_vel=ego, num_patches=200, rng=rng,
                             noise_sigma=0.01)
        frames.append(simulate_frame(cfg, scene, rng))
    root = str(tmp_path_factory.mktemp("flow"))
    write_dataset(root, np.stack(frames), odom=np.stack([make_odom_rows(ego)] * FLOW_FRAMES))
    return root


def test_velocity_analysis_flow_equals_the_jax_scripts(flow_recording, flagship_cfg_path):
    with open(os.path.join(REPO, "analyzer_configs", "velocity_analysis_config.yaml")) as fh:
        params = yaml.safe_load(fh)
    cfg = load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")
    dataset = CpslDS(flow_recording)
    estimator = build_estimator(cfg, params, device="cpu")
    estimator._draw_scores = JaxKeyStream(42)
    est, gt = analyze_velocity(dataset, cfg, params, device="cpu", estimator=estimator)

    # the loop of scripts/test_vel_estimation.py, on the JAX package
    jcfg = jax_load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")
    reformatter = JaxReformatter(jcfg)
    generator = JaxPointCloudGenerator(jcfg, **params["processors"]["point_cloud_generator"])
    ve = params["processors"]["velocity_estimator"]
    ref_estimator = JaxPointsVE(jcfg, min_R2_threshold=ve["min_r2_threshold"],
                                min_inlier_percent=ve["min_inlier_percent"])
    want, want_gt = [], []
    for i in range(dataset.num_frames):
        adc = np.asarray(reformatter.process(dataset.get_radar_adc_data(i)))
        want.append(ref_estimator.process(points=generator.process(adc)))
        want_gt.append(np.mean(dataset.get_vehicle_odom_data(i)[:, 8:11], axis=0))
    want, want_gt = np.array(want), np.array(want_gt)

    assert est.shape == gt.shape == (FLOW_FRAMES, 3)
    np.testing.assert_array_equal(gt, want_gt)
    np.testing.assert_allclose(est, want, rtol=0, atol=VELOCITY_ATOL)
    assert np.count_nonzero(est[:, 0]) >= FLOW_FRAMES - 2  # not a vacuous comparison
    assert len(estimator.history_estimated) == FLOW_FRAMES
    port, ref = VelocityAnalyzer(), JaxVelocityAnalyzer()
    port.analyze(est, gt)
    ref.analyze(want, want_gt)
    np.testing.assert_allclose(port.generate_report().values, ref.generate_report().values,
                               rtol=0, atol=VELOCITY_ATOL)
    # a window of the recording, as --start-idx / --end-idx give it
    est_w, _ = analyze_velocity(dataset, cfg, params, device="cpu", start=3, end=5)
    assert est_w.shape == (2, 3)
