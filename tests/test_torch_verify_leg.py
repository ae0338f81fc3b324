"""The port's verify leg against the committed JAX oracle and the JAX package, on the CPU.

- ``run_verify(..., device="cpu")`` holds the port to
  ``tests/oracles/jax_verify_b32_s7.npz`` (the JAX package's outputs of
  ``make_inputs(flagship, 32, seed=7)``, with JAX's RANSAC draws) at the JAX
  package's gates, for each of the six metrics; the port's output keys,
  shapes and dtypes equal the oracle's;
- a corrupted output (a capon map times 2, point sets moved to the next
  frame, a velocity off by 0.5 m/s, a missing leaf) fails it;
- the gates and their report equal the JAX package's;
- the oracle regenerated from the JAX package on this machine agrees with
  the committed file through ``compare_outputs`` at the raised gates (the
  file need not be bit-equal: another CPU may order float sums otherwise);
- ``scripts/torch_verify_detectors.py`` prints the table of
  ``scripts/verify_detectors.py``, and its detections equal the JAX
  detectors'.
"""

import importlib.util
import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu.detectors import get_detector_registry as jax_registry
from mmwave_radar_processing_tpu.utils import verify as jax_verify
from mmwave_radar_processing_tpu_torch.utils import verify

torch.set_num_threads(2)  # tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


make_oracles = _load("tests/oracles/make_oracles.py", "make_oracles")
twin = _load("scripts/torch_verify_detectors.py", "torch_verify_detectors")


@pytest.fixture(scope="module")
def oracle():
    return verify.load_oracle()


@pytest.fixture(scope="module")
def port_outputs(oracle):
    return verify.compute_outputs(verify.flagship_config(), verify.VERIFY_METRICS, 32,
                                  device="cpu", gumbel=oracle[1]["gumbel"])


# --------------------------------------------------------------------------- #
# the port against the committed oracle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("metric", verify.VERIFY_METRICS)
def test_port_passes_run_verify_against_the_jax_oracle(metric):
    report = verify.run_verify([metric], 32, device="cpu")
    failed = [leaf for leaf in report["leaves"] if not leaf["ok"]]
    assert report["ok"] and not failed, failed
    assert report["device"] == "cpu" and report["batch"] == 32 and report["seed"] == 7
    assert report["oracle"] == os.path.join("tests", "oracles", "jax_verify_b32_s7.npz")
    assert {leaf["leaf"].split("/", 1)[0] for leaf in report["leaves"]} == {metric}
    kinds = {leaf.get("comparison") for leaf in report["leaves"]}
    if metric in ("pointcloud_f32", "combined", "ground"):
        assert {"set_iou", "count_within_2"} <= kinds  # the point sets are scored as sets


def test_output_keys_shapes_and_dtypes_equal_the_oracle(oracle, port_outputs):
    outputs, inputs = oracle
    assert sorted(port_outputs) == sorted(outputs)
    for key, want in outputs.items():
        got = port_outputs[key]
        assert (got.shape, got.dtype) == (want.shape, want.dtype), key
    # the names the JAX package's tree paths give, not an invented layout
    for key in ("pointcloud_f32/points", "combined/0/valid", "combined/1/vx",
                "ground/final_altitude", "capon/out", "bartlett/out", "velocity/az_r2"):
        assert key in outputs
    assert outputs["ground/final_altitude"].shape == ()
    assert inputs["seed"] == 7 and inputs["gumbel"].shape == (32, 2, 20, 70)
    assert int(outputs["pointcloud_f32/count"].sum()) > 0


def _rolled_points(out):
    for key in ("pointcloud_f32/points", "pointcloud_f32/valid"):
        out[key] = np.roll(out[key], 1, axis=0)


CORRUPTIONS = {
    "capon_times_2": (["capon"], lambda out: out.__setitem__("capon/out", out["capon/out"] * 2),
                      "capon/out"),
    "points_of_another_frame": (["pointcloud_f32"], _rolled_points, "pointcloud_f32/points"),
    "velocity_off": (["velocity"], lambda out: out.__setitem__(
        "velocity/vx", out["velocity/vx"] + 0.5), "velocity/vx"),
    "missing_leaf": (["ground"], lambda out: out.pop("ground/final_altitude"),
                     "ground/final_altitude"),
}


@pytest.mark.parametrize("case", list(CORRUPTIONS))
def test_a_corrupted_output_fails_run_verify(monkeypatch, case):
    metrics, corrupt, leaf = CORRUPTIONS[case]
    honest = verify.compute_outputs

    def corrupted(*args, **kw):
        out = honest(*args, **kw)
        corrupt(out)
        return out

    monkeypatch.setattr(verify, "compute_outputs", corrupted)
    report = verify.run_verify(metrics, 32, device="cpu")
    assert not report["ok"]
    assert [entry["leaf"] for entry in report["leaves"] if not entry["ok"]] == [leaf]


def test_run_verify_refuses_what_the_oracle_does_not_hold(tmp_path):
    with pytest.raises(ValueError, match="seed"):
        verify.run_verify(["capon"], 32, seed=8, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        verify.run_verify(["capon"], 8, device="cpu")
    with pytest.raises(ValueError, match="no outputs"):
        verify.run_verify(["pointcloud"], 32, device="cpu")
    np.savez_compressed(tmp_path / "o.npz", **{"velocity/vx": np.zeros(32, np.float32),
                                               "seed": np.int64(7)})
    with pytest.raises(ValueError, match="RANSAC draws"):
        verify.run_verify(["velocity"], 32, device="cpu", oracle_path=str(tmp_path / "o.npz"))


def test_dump_oracle_round_trips_through_run_verify(tmp_path, oracle):
    path = str(tmp_path / "port.npz")
    verify.dump_oracle(["capon", "velocity"], 64, path, device="cpu",
                       gumbel=oracle[1]["gumbel"])
    outputs, inputs = verify.load_oracle(path)
    assert sorted(outputs) == sorted(k for k in oracle[0] if k.split("/")[0] in
                                     ("capon", "velocity"))
    np.testing.assert_array_equal(inputs["gumbel"], oracle[1]["gumbel"])
    report = verify.run_verify(["capon", "velocity"], 32, device="cpu", oracle_path=path,
                               out_path=str(tmp_path / "r.json"))
    assert report["ok"] and all(leaf.get("max_abs_delta", 0) == 0 for leaf in report["leaves"])
    assert (tmp_path / "r.json").stat().st_size > 0


class _Inner(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_named_leaves_follow_jax_tree_paths():
    t = torch.zeros(1)
    assert [n for n, _ in verify.named_leaves(t)] == ["out"]
    assert [n for n, _ in verify.named_leaves((_Inner(t, t), _Inner(t, t)))] == [
        "0/a", "0/b", "1/a", "1/b"]
    with pytest.raises(TypeError):
        list(verify.named_leaves({"a": t}))


def test_gates_equal_the_jax_package():
    for name in ("MIN_DISCRETE_AGREEMENT", "FLOAT_ATOL", "FLOAT_RTOL", "MIN_POINTS_IOU",
                 "MIN_COUNT_NEAR", "METRIC_POINTS_IOU", "METRIC_COUNT_NEAR"):
        assert getattr(verify, name) == getattr(jax_verify, name), name
    assert set(verify.VERIFY_METRICS) < set(jax_verify.VERIFY_METRICS)
    assert verify.MAX_VERIFY_BATCH == 32


def test_compare_outputs_report_equals_jax(oracle, port_outputs):
    outputs = oracle[0]
    shifted = {k: (v + np.float32(0.01) if v.dtype == np.float32 else v)
               for k, v in port_outputs.items()}
    assert verify.compare_outputs(outputs, shifted) == jax_verify.compare_outputs(outputs,
                                                                                shifted)


# --------------------------------------------------------------------------- #
# the oracle regenerated from the JAX package
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("metric", verify.VERIFY_METRICS)
def test_regenerated_jax_oracle_agrees_with_the_committed_file(oracle, metric):
    fresh = make_oracles.jax_outputs([metric], batch=32, seed=7)
    committed = {k: v for k, v in oracle[0].items() if k.split("/", 1)[0] == metric}
    assert sorted(k for k in fresh if "/" in k) == sorted(committed)
    report = verify.compare_outputs(committed, {k: v for k, v in fresh.items() if "/" in k})
    assert report["ok"], [leaf for leaf in report["leaves"] if not leaf["ok"]]
    for leaf in report["leaves"]:  # at the raised gates, whatever the metric
        if leaf.get("comparison") == "set_iou":
            assert leaf["agree_frac"] >= verify.METRIC_POINTS_IOU["pointcloud_f32"], leaf
        elif leaf.get("comparison") == "count_within_2":
            assert leaf["agree_frac"] >= verify.METRIC_COUNT_NEAR["pointcloud_f32"], leaf
    if metric in ("velocity", "combined"):
        np.testing.assert_allclose(fresh["ransac_gumbel"], oracle[1]["gumbel"], rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------------------------- #
# the detector twin
# --------------------------------------------------------------------------- #
def test_detector_twin_prints_the_jax_scripts_table():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    runs = [subprocess.run([sys.executable, script, *args], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
            for script, args in (("scripts/verify_detectors.py", []),
                                 ("scripts/torch_verify_detectors.py", ["--device", "cpu"]))]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    assert runs[1].stdout == runs[0].stdout
    assert runs[1].stdout.count("PASS") == 6


def test_detector_twin_detections_equal_the_jax_detectors():
    rows = twin.run("cpu")
    registry = jax_registry()
    for row, (name, params, signal, target) in zip(rows, twin.cases(0)):
        want = registry[name](**params).detect(signal)
        assert row["name"] == name and row["detections"] == want, name
        assert row["ok"]
    assert twin.table(rows).splitlines()[0].split() == ["detector", "target", "hit",
                                                        "detections", "result"]


@pytest.mark.cuda
def test_run_verify_on_cuda_against_the_jax_oracle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    report = verify.run_verify(verify.VERIFY_METRICS, 32, device="cuda")
    assert report["ok"], [leaf for leaf in report["leaves"] if not leaf["ok"]]
