"""The port's bench entry point, its cost models and the two repaired faults, against the JAX package on the CPU.

- ``processors/range_doppler.range_doppler_map``'s ``window``: ``True`` (the
  default) is Hann and ``False`` none, as in the JAX package; a tensor is
  applied as given;
- the package's ``__version__``, ``utils``' exports and ``profiling.trace``'s
  ``host_tracer_level`` keyword, as the JAX package has them;
- ``bench_torch.py --device cpu`` for each metric in a subprocess, as
  ``tests/test_scripts.py`` runs ``bench.py``: ``bench.py``'s keys,
  ``vs_baseline`` null exactly for capon and bartlett, the roofline fields
  on the three metrics with a model; ``--metric scaling`` and a CUDA run
  without a CUDA device refused;
- ``bench_torch.py``'s constants, inputs and baselines equal to ``bench.py``'s;
- ``utils/roofline.py``'s models equal to the JAX module's on the flagship
  config (the peaks are the H100's, not the TPU's).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch
import mmwave_radar_processing_tpu as jax_package
import mmwave_radar_processing_tpu.utils as jax_utils
from mmwave_radar_processing_tpu.processors import range_doppler as jax_rd
from mmwave_radar_processing_tpu.utils import roofline as jax_roofline

import mmwave_radar_processing_tpu_torch as port
import mmwave_radar_processing_tpu_torch.utils as port_utils
from mmwave_radar_processing_tpu_torch.processors.range_doppler import (
    RangeDopplerProcessor,
    hann_window_2d,
    range_doppler_map,
)
from mmwave_radar_processing_tpu_torch.utils import profiling, roofline, verify

torch.set_num_threads(2)  # tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_frames_per_s",
              "baseline_workload", "per_repeat_frames_per_s", "card", "peak_mem_mb"}
ROOFLINE_KEYS = {"flops_per_frame", "bytes_per_frame", "tflops", "mfu", "hbm_gbs", "hbm_util",
                 "bound", "cost_source", "peak_tflops", "peak_gbs"}


# --------------------------------------------------------------------------- #
# the two repaired faults
# --------------------------------------------------------------------------- #
def _cube(shape=(4, 8, 16), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("window", [True, False, None], ids=["hann", "none", "default"])
def test_range_doppler_map_window_flag_matches_jax(window):
    cube = _cube()
    kw = {} if window is None else {"window": window}
    got = range_doppler_map(torch.from_numpy(cube), **kw).numpy()
    want = np.asarray(jax_rd.range_doppler_map(cube, **kw))
    scale = float(np.abs(want).max())
    assert scale > 1.0  # not the zeros that a False once multiplied in
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)


def test_range_doppler_map_takes_a_window_tensor_and_the_processor_keeps_hann():
    cube = torch.from_numpy(_cube((4, 8, 16), seed=1))
    hann = range_doppler_map(cube)
    assert torch.equal(range_doppler_map(cube, window=hann_window_2d(8, 16, "cpu")), hann)
    assert not torch.allclose(range_doppler_map(cube, window=False), hann)
    proc = RangeDopplerProcessor(port.load_cfg(os.path.join(
        REPO, "configs", "6843_RadVel_ods_20Hz.cfg"), "ods", "down"), device="cpu")
    assert torch.equal(proc.range_doppler(cube), hann)
    with pytest.raises(TypeError):
        range_doppler_map(cube, False)  # keyword-only, as in the JAX package


def test_package_exports_match_the_jax_package():
    assert port.__version__ == jax_package.__version__ == "0.1.0"
    assert "__version__" in port.__all__
    assert port_utils.__all__ == jax_utils.__all__
    for name in jax_utils.__all__:
        assert hasattr(port_utils, name), name
    assert port_utils.get_logger("x") is not None and callable(port_utils.setup_logger)
    np.testing.assert_array_equal(port_utils.rotations.get_rot_matrix(0.3),
                                  jax_utils.rotations.get_rot_matrix(0.3))


def test_trace_accepts_the_host_tracer_level_keyword(tmp_path):
    with profiling.trace(str(tmp_path / "t"), host_tracer_level=3):
        torch.ones(4).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert "host_tracer_level" in profiling.trace.__doc__


# --------------------------------------------------------------------------- #
# bench_torch.py
# --------------------------------------------------------------------------- #
def _run(args, timeout=300):
    return subprocess.run([sys.executable, "bench_torch.py", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=REPO))


@pytest.mark.parametrize("metric", bench_torch.METRICS)
def test_bench_torch_prints_bench_py_line(metric):
    r = _run(["--device", "cpu", "--batch", "2", "--iters", "1", "--repeats", "1",
              "--metric", metric])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert BENCH_KEYS <= set(out)
    assert out["unit"] == "frames/s" and out["value"] > 0
    assert len(out["per_repeat_frames_per_s"]) == 1
    assert out["device"] == "cpu" and out["card"] is None and out["peak_mem_mb"] is None
    if metric in ("capon", "bartlett"):
        assert out["vs_baseline"] is None and out["baseline_frames_per_s"] is None
    else:
        assert out["vs_baseline"] > 0 and out["baseline_frames_per_s"] > 0
        assert "not a GPU figure" in out["baseline_measured"]
    if metric in ("pointcloud", "capon", "bartlett"):
        assert ROOFLINE_KEYS <= set(out)
        assert out["cost_source"] == "analytic_model" and out["flops_per_frame"] > 0
        assert out["mfu"] is None  # a CPU run's rate is no device's
        assert (out["peak_tflops"], out["peak_gbs"]) == (67.0, 3350.0)
    else:
        assert not ROOFLINE_KEYS & set(out)


def test_bench_torch_refuses_scaling_and_a_missing_cuda_device():
    r = _run(["--metric", "sharding", "--device", "cpu"])
    assert r.returncode == 2 and "invalid choice: 'sharding'" in r.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for args in ([], ["--metric", "scaling"]):  # no fallback to the CPU, scaling included
        r = _run(["--batch", "2", "--iters", "1", "--repeats", "1", *args])
        assert r.returncode != 0 and not r.stdout.strip()
        assert "no CUDA device" in r.stderr


#: ``bench.py``'s ``run_scaling`` keys
SCALING_KEYS = {"metric", "value", "unit", "vs_baseline", "input_feed_included",
                "core_oversubscribed", "physical_cores", "predicted_ici_efficiency_min",
                "predicted_meets_80pct_bar", "table"}


def test_bench_torch_scaling_prints_run_scaling_line():
    r = _run(["--device", "cpu", "--metric", "scaling", "--batch", "16", "--iters", "1",
              "--repeats", "1"])
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert SCALING_KEYS | {"device_oversubscribed", "card", "device"} <= set(out)
    assert out["vs_baseline"] is None and out["unit"] == "fraction"
    assert out["device"] == "cpu" and out["card"] is None
    assert out["input_feed_included"] is True and out["value"] > 0
    table = out["table"]
    assert table["combined_with_feed"]["devices"] == [1, 2, 4]
    assert table["ppermute_halo_rows"]["devices"] == [2, 4]
    assert table["meta"]["per_device_batch"] == 1
    assert out["predicted_ici_efficiency_min"] is None  # no link is stated


def test_bench_torch_shares_bench_py_constants_and_baselines():
    assert verify.CFAR_PARAMS == bench.CFAR_PARAMS
    assert (verify.AZ_IDXS, verify.EL_IDXS) == (bench.AZ_IDXS, bench.EL_IDXS)
    assert bench_torch.BASELINE_WORKLOADS == bench.BASELINE_WORKLOADS
    for metric in bench_torch.METRICS:
        fps, workload, where = bench_torch.load_measured_baseline(metric)
        assert (fps, workload) == bench.load_measured_baseline(metric)
        assert (where is None) == (fps is None)


def test_bench_torch_inputs_are_bench_py_inputs():
    cfg = verify.flagship_config()
    shape = (3, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    for seed in (0, 1):
        re, im, alt = bench_torch.bench_args(cfg, 3, seed, True, "cpu")
        rng = np.random.default_rng(seed)
        np.testing.assert_array_equal(re.numpy(), rng.standard_normal(shape).astype(np.float32))
        np.testing.assert_array_equal(im.numpy(), rng.standard_normal(shape).astype(np.float32))
        np.testing.assert_array_equal(alt.numpy(), np.full(3, 1.2, np.float32))
    assert len(bench_torch.bench_args(cfg, 3, 0, False, "cpu")) == 2


def test_time_metric_records_every_repeat():
    timing = bench_torch.time_metric("capon", batch=2, iters=2, repeats=3, device="cpu")
    assert len(timing["per_repeat_frames_per_s"]) == 3
    assert timing["frames_per_s"] == max(timing["per_repeat_frames_per_s"]) > 0
    assert timing["ms_per_batch"] == pytest.approx(2 * 1e3 / timing["frames_per_s"])
    assert timing["peak_mem_mb"] is None


# --------------------------------------------------------------------------- #
# cost models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("metric", ["pointcloud", "velocity", "combined", "ground", "capon",
                                    "bartlett", "scaling"])
def test_cost_models_equal_jax(flagship_config, metric):
    cfg = verify.flagship_config()
    got = roofline.analytic_cost(metric, cfg)
    want = jax_roofline.analytic_cost(metric, flagship_config)
    if want is None:
        assert got is None
        return
    assert (got.flops_per_frame, got.bytes_per_frame) == (want.flops_per_frame,
                                                         want.bytes_per_frame)
    assert got.arithmetic_intensity == want.arithmetic_intensity


def test_cost_model_keywords_and_classify_bound_equal_jax(flagship_config):
    cfg = verify.flagship_config()
    pairs = [(roofline.pointcloud_cost(cfg, max_dets=64, num_train=(4, 6), num_guard=(2, 1)),
              jax_roofline.pointcloud_cost(flagship_config, max_dets=64, num_train=(4, 6),
                                           num_guard=(2, 1))),
             (roofline.capon_cost(cfg, n_ant=8, num_angle_bins=128),
              jax_roofline.capon_cost(flagship_config, n_ant=8, num_angle_bins=128)),
             (roofline.bartlett_cost(cfg, n_ant=12), jax_roofline.bartlett_cost(
                 flagship_config, n_ant=12))]
    for got, want in pairs:
        assert got == roofline.CostModel(want.flops_per_frame, want.bytes_per_frame)
    peaks = dict(peak_tflops=roofline.DEFAULT_PEAK_F32_TFLOPS,
                 peak_gbs=roofline.DEFAULT_PEAK_HBM_GBS)
    for tflops in (0.1, 5.0, 40.0, 80.0):
        for gbs in (10.0, 500.0, 3000.0, 5000.0):
            assert (roofline.classify_bound(tflops, gbs, **peaks)
                    == jax_roofline.classify_bound(tflops, gbs, **peaks))
    # the H100 SXM's published float32 (no tensor cores) and HBM3 peaks, not the TPU's
    assert (roofline.DEFAULT_PEAK_F32_TFLOPS, roofline.DEFAULT_PEAK_HBM_GBS) == (67.0, 3350.0)
    assert roofline.DEFAULT_PEAK_HBM_GBS != jax_roofline.DEFAULT_PEAK_HBM_GBS


def test_roofline_fields_from_the_model():
    fields = bench_torch.roofline_fields("capon", 1e6, on_device=True)
    model = roofline.capon_cost(verify.flagship_config())
    tflops, gbs = 1e6 * model.flops_per_frame / 1e12, 1e6 * model.bytes_per_frame / 1e9
    assert fields["tflops"] == round(tflops, 3) and fields["mfu"] == round(tflops / 67.0, 4)
    assert fields["hbm_gbs"] == round(gbs, 2) and fields["hbm_util"] == round(gbs / 3350.0, 4)
    assert fields["bound"] == roofline.classify_bound(tflops, gbs)
    assert bench_torch.roofline_fields("velocity", 1e6, on_device=True) == {}
