"""The port's recording runner and scripts against the JAX package's scripts on the CPU.

A 20-frame simulated recording (ground scenes at a gradual altitude, the
odometry beside them) is served at batch 8 (two full batches and a tail of
4) by ``scripts/process_recording.py`` (JAX, ``JAX_PLATFORMS=cpu``) and by
``scripts/torch_process_recording.py --device cpu``, in each of the three
modes (combined, ``--no-velocity``, ``--detector ground``):

- the ``.npz`` keys and dtypes are equal, ``valid`` identical, points within
  1e-5 and ``compare_outputs`` at its raised gates; the ground altitude
  within 1e-4 m;
- velocity: ``process_recording(..., gumbel=jax_draws(42, 8, n))`` against
  the JAX script's output, computed by the JAX combined pipeline on batches
  zero-padded to 8 (the tail's frames take the first draws of
  ``split(PRNGKey(42), 8)``, as ``gumbel[:b]`` does): within 1e-4;
- the runner in-process, with the numpy reader, equals the script's output;
  another batch size gives the same frames (the ground scan's altitude
  carried across batches);
- both ``simulate_dataset`` scripts write byte-identical files.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import load_cfg
from mmwave_radar_processing_tpu_torch.data import (
    CpslDS,
    ground_scene,
    make_odom_rows,
    simulate_frame,
    write_dataset,
)
from mmwave_radar_processing_tpu_torch.parallel.recording import (
    MODES,
    build_recording_pipeline,
    process_recording,
)
from mmwave_radar_processing_tpu_torch.utils.profiling import StageTimer
from mmwave_radar_processing_tpu_torch.utils.verify import compare_outputs
from test_torch_velocity_pipeline import SEED, jax_draws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, BATCH = 20, 8
POINTS_ATOL, ALTITUDE_ATOL, VELOCITY_ATOL = 1e-5, 1e-4, 1e-4
EGO = (0.8, 0.3, -0.1)
#: the JAX script's flags for each mode of the runner
MODE_FLAGS = {"2d": [], "points": ["--no-velocity"], "ground": ["--detector", "ground"]}
EXPECTED_KEYS = {"2d": ["points", "valid", "velocity"], "points": ["points", "valid"],
                 "ground": ["altitude", "points", "valid"]}


@pytest.fixture(scope="module")
def cfg(flagship_cfg_path):
    return load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")


@pytest.fixture(scope="module")
def recording(tmp_path_factory, cfg):
    """20 ground frames, the altitude rising gradually from 0.6 m to 1.2 m, then level."""
    rng = np.random.default_rng(5)
    frames = []
    for i in range(FRAMES):
        alt = 0.6 + 0.6 * min(1.0, i / 10)
        scene = ground_scene(cfg, altitude_m=alt, ego_vel=np.array(EGO), num_patches=200,
                             rng=rng, noise_sigma=0.01)
        frames.append(simulate_frame(cfg, scene, rng))
    root = str(tmp_path_factory.mktemp("recording"))
    write_dataset(root, np.stack(frames), odom=np.stack([make_odom_rows(EGO)] * FRAMES))
    return root


def _script(name, *args, device_cpu=False, jax_cpu=False):
    env = dict(os.environ)
    if jax_cpu:
        env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, os.path.join(REPO, "scripts", name), *args]
    if device_cpu:
        cmd += ["--device", "cpu"]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    for proc in procs:
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out[-3000:]


@pytest.fixture(scope="module")
def outputs(recording, tmp_path_factory):
    """``{mode: (JAX npz, port npz)}``: both scripts in each mode, all six run at once."""
    out_dir = tmp_path_factory.mktemp("npz")
    paths, procs = {}, []
    for mode, flags in MODE_FLAGS.items():
        jax_out, port_out = str(out_dir / f"jax_{mode}.npz"), str(out_dir / f"port_{mode}.npz")
        common = ["--dataset", recording, "--batch", str(BATCH), *flags]
        procs.append(_script("process_recording.py", *common, "--out", jax_out, jax_cpu=True))
        procs.append(_script("torch_process_recording.py", *common, "--out", port_out,
                             device_cpu=True))
        paths[mode] = (jax_out, port_out)
    _wait(procs)
    loaded = {}
    for mode, (jax_out, port_out) in paths.items():
        with np.load(jax_out) as want, np.load(port_out) as got:
            loaded[mode] = ({k: want[k] for k in want.files}, {k: got[k] for k in got.files})
    return loaded


def _assert_point_clouds_agree(got, want):
    assert got["points"].shape == (FRAMES, 128, 4)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["points"], want["points"], rtol=0, atol=POINTS_ATOL)
    assert got["valid"].sum() > 10 * FRAMES  # not a vacuous comparison

    def leaves(out):
        return {"pointcloud_f32/points": out["points"], "pointcloud_f32/valid": out["valid"],
                "pointcloud_f32/count": out["valid"].sum(1).astype(np.int32)}

    report = compare_outputs(leaves(want), leaves(got))
    gates = {leaf["leaf"]: leaf.get("gate") for leaf in report["leaves"]}
    assert gates["pointcloud_f32/points"] == 0.95 and gates["pointcloud_f32/count"] == 0.95
    assert report["ok"], report


@pytest.mark.parametrize("mode", MODES)
def test_npz_keys_and_dtypes_equal_the_jax_scripts(outputs, mode):
    want, got = outputs[mode]
    assert sorted(got) == sorted(want) == EXPECTED_KEYS[mode]
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key


@pytest.mark.parametrize("mode", MODES)
def test_point_clouds_equal_the_jax_scripts(outputs, mode):
    want, got = outputs[mode]
    _assert_point_clouds_agree(got, want)


def test_ground_altitude_equals_the_jax_scripts(outputs):
    want, got = outputs["ground"]
    np.testing.assert_allclose(got["altitude"], want["altitude"], rtol=0, atol=ALTITUDE_ATOL)
    assert float(np.ptp(want["altitude"])) > 0.3  # the track followed the climb


def test_velocity_equals_the_jax_script_with_its_draws(outputs, recording, cfg):
    want, script_out = outputs["2d"]
    n = build_recording_pipeline(cfg, "2d", device="cpu").velocity.ransac_rows
    got = process_recording(CpslDS(recording), cfg, mode="2d", batch=BATCH, device="cpu",
                            gumbel=torch.from_numpy(jax_draws(SEED, BATCH, n)))
    np.testing.assert_allclose(got["velocity"], want["velocity"], rtol=0, atol=VELOCITY_ATOL)
    assert np.count_nonzero(want["velocity"][:, 0]) >= FRAMES // 2  # fits that pass the gates
    np.testing.assert_array_equal(got["valid"], want["valid"])
    # the script draws from the pipeline's own seeded generator: vx is draw-free
    np.testing.assert_allclose(script_out["velocity"][:, 2], want["velocity"][:, 2], rtol=0,
                               atol=VELOCITY_ATOL)


@pytest.mark.parametrize("mode", ["points", "ground"])
def test_runner_in_process_equals_the_script(outputs, recording, cfg, mode):
    _, script_out = outputs[mode]
    timer = StageTimer()
    got = process_recording(CpslDS(recording), cfg, mode=mode, batch=BATCH, device="cpu",
                            timer=timer, backend="numpy", loader_threads=2)
    assert sorted(got) == EXPECTED_KEYS[mode]
    for key in got:
        np.testing.assert_array_equal(got[key], script_out[key], err_msg=key)
    batches = -(-FRAMES // BATCH)
    for stage in ("load", "load_wait", "compute"):
        assert timer.counts[stage] == batches and timer.items[stage] == FRAMES, stage
    assert timer.counts["wall"] == 1 and timer.items["wall"] == FRAMES
    assert "h2d" not in timer.totals and "device_busy" not in timer.totals  # CUDA only


@pytest.mark.parametrize("mode", ["points", "ground"])
def test_other_batch_sizes_give_the_same_frames(outputs, recording, cfg, mode):
    _, script_out = outputs[mode]
    paths = CpslDS(recording)._files["radar_adc"]
    for batch in (3, FRAMES):
        got = process_recording(paths, cfg, mode=mode, batch=batch, device="cpu")
        np.testing.assert_array_equal(got["valid"], script_out["valid"])
        np.testing.assert_allclose(got["points"], script_out["points"], rtol=0, atol=POINTS_ATOL)
        if mode == "ground":  # the tracker's state carried across every batch boundary
            np.testing.assert_allclose(got["altitude"], script_out["altitude"], rtol=0,
                                       atol=1e-6)


def test_runner_refuses_what_it_cannot_serve(recording, cfg):
    ds = CpslDS(recording)
    with pytest.raises(TypeError):
        process_recording(ds, cfg, mode="points", batch=BATCH)  # no implicit device
    with pytest.raises(ValueError, match="mode"):
        process_recording(ds, cfg, mode="3d", batch=BATCH, device="cpu")
    with pytest.raises(ValueError, match="no radar frames"):
        process_recording([], cfg, mode="points", device="cpu")
    with pytest.raises(ValueError, match="gumbel"):
        process_recording(ds, cfg, mode="2d", batch=BATCH, device="cpu",
                          gumbel=torch.zeros((BATCH - 1, 2, 20, 70)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            process_recording(ds, cfg, mode="points", batch=BATCH, device="cuda")


def test_script_runs_on_the_cpu_only_when_asked(recording, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _script("torch_process_recording.py", "--dataset", recording, "--out",
                   str(tmp_path / "x.npz"), "--no-velocity")
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in out
    assert not (tmp_path / "x.npz").exists()


def test_simulate_scripts_write_identical_files(tmp_path):
    args = ["--frames", "3", "--patches", "16", "--ramp-frames", "2", "--seed", "3"]
    procs = [_script(name, "--out", str(tmp_path / name), *args)
             for name in ("simulate_dataset.py", "torch_simulate_dataset.py")]
    _wait(procs)
    jax_root, port_root = tmp_path / "simulate_dataset.py", tmp_path / "torch_simulate_dataset.py"
    files = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*.npy"))
    assert len(files) == 6  # 3 frames and 3 odometry blocks
    assert sorted(p.relative_to(port_root) for p in port_root.rglob("*.npy")) == files
    for rel in files:
        assert (port_root / rel).read_bytes() == (jax_root / rel).read_bytes(), rel
