"""The port's CFAR detector classes against the JAX package's, and against the goldens.

The inputs are a simulated frame's range profile and range-Doppler map (the
golden scenario's) and quantized noise with planted targets.  Bars:

- OS detectors: detection lists, thresholds and noise **equal** (a k-th
  smallest is exact on both sides).
- CA/GO/SO detectors: noise and thresholds within ``SUM_RTOL`` = 1e-5 (a
  float32 sum over up to 220 cells in another order); detection lists equal,
  except at cells within that band of the threshold.
- The goldens pass under the scenario's own ``compare`` (detection sets
  equal, noise within rtol 1e-4).
"""

import functools
import os

import numpy as np
import pytest
import torch

from golden_scenarios import CFAR_CASES, GOLDEN_DIR, SCENARIOS
from mmwave_radar_processing_tpu.detectors import get_detector_registry as jax_registry
from mmwave_radar_processing_tpu_torch import detectors, get_detector_registry
from mmwave_radar_processing_tpu_torch.detectors import BaseCFAR1D, BaseCFAR2D

torch.set_num_threads(2)

SUM_RTOL = 1e-5
NAMES = ("ca_cfar_1d", "ca_cfar_2d", "os_cfar_1d", "os_cfar_2d", "go_cfar_1d", "so_cfar_1d")
CASES = list(CFAR_CASES) + [
    ("os_cfar_1d", dict(num_train=12, num_guard=4, rho=0.5, alpha=15.0), "profile"),
    ("os_cfar_2d", dict(num_train=(4, 6), num_guard=(2, 1), rho=0.5, alpha=3.0), "rd_map"),
    ("ca_cfar_2d", dict(num_train=(3, 4), num_guard=(1, 1), pfa=1e-4), "rd_map"),
]
CASE_IDS = [f"{name}-{i}" for i, (name, _, _) in enumerate(CASES)]


@pytest.fixture(scope="module")
def signals():
    """The golden scenario's profile and map, and quantized noise with targets (ties forced)."""
    inputs = dict(SCENARIOS["cfar_detectors"].make_inputs())
    rng = np.random.default_rng(21)
    noise_map = np.round(rng.exponential(1.0, (63, 70)) * 8) / 8
    noise_map[20, 30] = noise_map[41, 12] = noise_map[30, 50] = 60.0
    noise_profile = np.round(rng.exponential(1.0, (63,)) * 8) / 8
    noise_profile[[17, 40]] = 50.0
    return {"golden": inputs,
            "quantized": {"rd_map": noise_map, "profile": noise_profile}}


def test_registry_names_and_classes():
    ours, theirs = get_detector_registry(), jax_registry()
    assert tuple(ours) == tuple(theirs) == NAMES
    for name, cls in ours.items():
        assert cls.__name__ == theirs[name].__name__
        assert issubclass(cls, BaseCFAR2D if name.endswith("2d") else BaseCFAR1D)
    assert set(detectors.__all__) >= {cls.__name__ for cls in ours.values()}


@pytest.mark.parametrize("source", ["golden", "quantized"])
@pytest.mark.parametrize("name,params,signal", CASES, ids=CASE_IDS)
def test_detector_matches_jax(signals, name, params, signal, source):
    x = signals[source][signal]
    ours = get_detector_registry()[name](device="cpu", **params)
    theirs = jax_registry()[name](**params)
    got, want = ours.detect(x), theirs.detect(x)
    thr, thr_j = ours.thresholds.numpy(), np.asarray(theirs.thresholds)
    noise, noise_j = ours.noise_estimates.numpy(), np.asarray(theirs.noise_estimates)
    assert len(want) > 0 and ours.detections.dtype == bool
    np.testing.assert_array_equal(ours.detections, np.asarray(ours.thresholds < torch.from_numpy(
        np.asarray(x, np.float32))))
    if name.startswith("os"):
        assert got == want
        np.testing.assert_array_equal(thr, thr_j)
        np.testing.assert_array_equal(noise, noise_j)
        return
    np.testing.assert_allclose(noise, noise_j, rtol=SUM_RTOL, atol=0)
    finite = np.isfinite(thr_j)
    np.testing.assert_array_equal(np.isfinite(thr), finite)
    np.testing.assert_allclose(thr[finite], thr_j[finite], rtol=SUM_RTOL, atol=0)
    differ = ours.detections != np.asarray(theirs.detections)
    x32 = np.asarray(x, np.float32)
    assert np.all(np.abs(x32 - thr_j)[differ] <= SUM_RTOL * thr_j[differ])
    if not differ.any():
        assert got == want


def test_detect_returns_python_indices(signals):
    det1 = get_detector_registry()["os_cfar_1d"](num_train=5, num_guard=3, rho=0.5,
                                                 alpha=2.0, device="cpu")
    out1 = det1.detect(signals["quantized"]["profile"])
    assert out1 and all(isinstance(i, int) for i in out1) and out1 == sorted(out1)
    assert det1.k_rank == 5
    det2 = get_detector_registry()["os_cfar_2d"](num_train=(5, 5), num_guard=(3, 2), rho=0.7,
                                                 alpha=4.0, device="cpu")
    out2 = det2.detect(torch.from_numpy(signals["quantized"]["rd_map"]))  # a float64 tensor
    assert out2 == sorted(out2) and all(isinstance(r, int) and isinstance(c, int)
                                       for r, c in out2)
    assert {(20, 30), (41, 12), (30, 50)} <= set(out2)
    assert det2.thresholds.dtype == torch.float32 and det2.noise_estimates.shape == (63, 70)


def test_short_signals_detect_nothing():
    for name, params, _ in CFAR_CASES:
        det = get_detector_registry()[name](device="cpu", **params)
        x = np.ones((5,) if name.endswith("1d") else (5, 5))
        assert det.detect(x) == []
        assert bool(torch.isinf(det.thresholds).all())


@pytest.mark.parametrize("name,params,signal", CFAR_CASES, ids=[c[0] for c in CFAR_CASES])
def test_device_is_required_and_cuda_raises_without_a_gpu(name, params, signal):
    cls = get_detector_registry()[name]
    with pytest.raises(TypeError):
        cls(**params)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(device="cuda", **params)


def test_compute_alpha_ca():
    cls = get_detector_registry()["ca_cfar_1d"]
    assert cls.compute_alpha_ca(16, 1e-3) == jax_registry()["ca_cfar_1d"].compute_alpha_ca(16, 1e-3)


def test_plot_detections_runs_on_the_host(signals):
    import matplotlib
    matplotlib.use("Agg")
    registry = get_detector_registry()
    det = registry["ca_cfar_1d"](num_train=8, num_guard=3, pfa=1e-3, device="cpu")
    ax = det.plot_detections(signals["quantized"]["profile"])
    assert len(ax.lines) == 4
    det = registry["ca_cfar_2d"](num_train=(5, 5), num_guard=(3, 2), pfa=1e-3, device="cpu")
    ax = det.plot_detections(signals["quantized"]["rd_map"])
    assert len(ax.images) == 1


def test_golden_cfar_detectors_through_the_ports_registry(signals):
    """``cfar_detectors.npz`` with the scenario's ``_run`` body and its own ``compare``."""
    registry = {name: functools.partial(cls, device="cpu")
                for name, cls in get_detector_registry().items()}
    inputs = signals["golden"]
    out = {}
    for name, params, signal in CFAR_CASES:
        det = registry[name](**params)
        out[f"{name}:dets"] = np.atleast_2d(np.asarray(det.detect(inputs[signal]), int))
        out[f"{name}:noise"] = det.noise_estimates.numpy().astype(np.float64)
    golden = dict(np.load(os.path.join(GOLDEN_DIR, "cfar_detectors.npz")))
    SCENARIOS["cfar_detectors"].compare(out, golden)
