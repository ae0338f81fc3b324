"""The synthetic-aperture steering phases on the CPU: plain version, dispatch, the kernel's wrapper.

``processors.synthetic_array.steering_phases`` dispatches on the device: a
CPU tensor takes the plain version (a GEMM, two in-place scalings and
``torch.polar``), a CUDA tensor the hand-written kernel
(``csrc/steering_phases.cu``) or raises.  Here:

- on CPU tensors the phases equal the plain version's three lines bit for
  bit, and no caller builds or loads the kernel;
- the wrapper refuses what the kernel does not take before any build;
- the kernel's arithmetic (a multiply and two FMAs, the two float32
  factors, an accurate sine and cosine), modelled in numpy, stays within
  ``STEERING_ATOL`` = 1e-4 of the plain version at the RadSAR cell's
  widths: angles of up to ~500 rad carry a float32 rounding of ~3e-5 each
  step, and the two round their steps apart.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import build_synthetic_aperture_pipeline, load_cfg
from mmwave_radar_processing_tpu_torch.ops.kernels import _build
from mmwave_radar_processing_tpu_torch.ops.kernels import steering as kernel
from mmwave_radar_processing_tpu_torch.processors import synthetic_array as sa
from steering_inputs import LAMBDA_M, STEERING_ATOL, cruise_positions, steering_grid

torch.set_num_threads(2)  # tier-1 runs several xdist workers

CFG_PATH = Path(__file__).resolve().parents[1] / "configs" / "RadSAR_1843_official.cfg"


def _three_lines(steering, positions, lambda_m):
    """The plain version as it stood before the kernel: the bar the CPU path is held to."""
    phase = steering @ positions
    phase.mul_(2 * np.pi).div_(lambda_m)
    return torch.polar(torch.ones((), dtype=phase.dtype, device=phase.device), phase)


@pytest.fixture
def no_build(monkeypatch):
    """``_build.load`` raises: a test that passes never built or loaded a kernel."""
    def refuse(name):
        raise AssertionError(f"the kernel {name} was built or loaded")

    monkeypatch.setattr(_build, "load", refuse)


@pytest.mark.parametrize("shape", [(3, 40), (2, 3, 57), (2, 2, 3, 16)],
                         ids=["2d", "batched", "two_leading_axes"])
def test_cpu_phases_equal_the_three_lines_bit_for_bit(no_build, shape):
    g = torch.Generator().manual_seed(len(shape))
    positions = 0.1 * torch.randn(shape, generator=g)
    steering = steering_grid(6, 4)
    before = kernel.steering_phases.launches
    got = sa.steering_phases(steering, positions, LAMBDA_M)
    want = _three_lines(steering, positions, LAMBDA_M)
    assert got.dtype == torch.complex64 and got.is_contiguous()
    assert got.shape == (*shape[:-2], 24, shape[-1])
    assert torch.equal(got, want)
    assert torch.equal(sa.steering_phases_reference(steering, positions, LAMBDA_M), want)
    assert kernel.steering_phases.launches == before


def _small_pipeline():
    cfg = load_cfg(str(CFG_PATH), array_geometry="standard")
    pipe = build_synthetic_aperture_pipeline(
        cfg, num_frames=3, az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 8)),
        el_angle_bins_rad=np.array([0.0]), output="depth", device="cpu")
    g = torch.Generator().manual_seed(3)
    shape = (4, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    vels = torch.tensor([0.2, 0.01, 0.0]).repeat(4, 1)
    return lambda: pipe(torch.randn(shape, generator=g), torch.randn(shape, generator=g), vels)


@pytest.mark.parametrize("caller", ["phases", "beamform", "array_factor", "pipeline"])
def test_cpu_callers_never_build_or_load_the_kernel(no_build, caller):
    steering, positions = steering_grid(5, 2), cruise_positions(1, num_frames=2, chirps=9)[0]
    calls = {
        "phases": lambda: sa.steering_phases(steering, positions, LAMBDA_M),
        "beamform": lambda: sa.beamform(
            torch.ones((7, positions.shape[-1]), dtype=torch.complex64), positions, steering,
            LAMBDA_M, torch.ones(7), torch.ones(positions.shape[-1])),
        "array_factor": lambda: sa.array_factor_pattern(positions, steering, LAMBDA_M),
        "pipeline": lambda: _small_pipeline()(),
    }
    before = kernel.steering_phases.launches
    calls[caller]()
    assert kernel.steering_phases.launches == before


@pytest.mark.parametrize("case", ["cpu", "meta", "float64_steering", "float64_positions",
                                  "strided_steering", "strided_positions", "steering_shape",
                                  "positions_shape", "positions_1d"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take_before_any_build(no_build, case):
    steering, positions = steering_grid(4, 2), 0.1 * torch.ones((2, 3, 10))
    err, match = ValueError, None
    if case == "cpu":
        match = "needs a CUDA tensor"
    elif case == "meta":
        steering, positions, match = steering.to("meta"), positions.to("meta"), "CUDA tensor"
    elif case == "float64_steering":
        steering, err, match = steering.double(), TypeError, "float32 steering"
    elif case == "float64_positions":
        positions, err, match = positions.double(), TypeError, "float32 positions"
    elif case == "strided_steering":
        steering, match = torch.zeros((8, 6))[:, ::2], "contiguous steering"
    elif case == "strided_positions":
        positions, match = torch.zeros((2, 3, 20))[..., ::2], "contiguous positions"
    elif case == "steering_shape":
        steering, match = torch.zeros((8, 2)), r"expected shape \(A, 3\)"
    elif case == "positions_shape":
        positions, match = torch.zeros((2, 4, 10)), r"expected shape \[\.\.\., 3, E\]"
    else:
        positions, match = torch.zeros(30), r"expected shape \[\.\.\., 3, E\]"
    before = kernel.steering_phases.launches
    with pytest.raises(err, match=match):
        kernel.steering_phases(steering, positions, LAMBDA_M)
    assert kernel.steering_phases.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_dispatch_sends_every_other_device_to_the_kernel(no_build, dtype):
    """Off the CPU there is no plain path: the kernel takes float32 CUDA tensors or raises."""
    steering = steering_grid(3, 1).to("meta", dtype)
    positions = torch.zeros((3, 8), device="meta", dtype=dtype)
    err = TypeError if dtype == torch.float64 else ValueError
    with pytest.raises(err):
        sa.steering_phases(steering, positions, LAMBDA_M)


def _kernel_model(steering: np.ndarray, positions: np.ndarray, lambda_m: float) -> np.ndarray:
    """``csrc/steering_phases.cu``'s arithmetic in numpy: float32 steps, an FMA as one rounding."""
    two_pi, inv_lambda = kernel.angle_factors(lambda_m)
    d = steering.astype(np.float32)
    p = positions.astype(np.float32)[..., None, :, :]  # [..., 1, 3, E]
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    dx, dy, dz = (d[:, k, None] for k in range(3))  # [A, 1]
    dot = dx * x
    # an FMA rounds once: the product is exact in float64 (48 bits)
    dot = (dy.astype(np.float64) * y + dot).astype(np.float32)
    dot = (dz.astype(np.float64) * z + dot).astype(np.float32)
    angle = (dot * two_pi) * inv_lambda
    return (np.cos(angle.astype(np.float64)) + 1j * np.sin(angle.astype(np.float64))
            ).astype(np.complex64)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_kernels_arithmetic_stays_within_its_bar_of_the_plain_version(seed):
    steering, positions = steering_grid(), cruise_positions(2, seed=seed)  # [960, 3], [2, 3, 800]
    want = sa.steering_phases(steering, positions, LAMBDA_M).numpy()
    got = _kernel_model(steering.numpy(), positions.numpy(), LAMBDA_M)
    assert got.shape == want.shape == (2, 960, 800)
    max_angle = float((steering @ positions).abs().max()) * 2 * np.pi / LAMBDA_M
    assert max_angle > 400  # the range the bar is set for
    assert float(np.abs(got - want).max()) <= STEERING_ATOL


def test_the_angle_factors_round_as_pytorch_does():
    two_pi, inv_lambda = kernel.angle_factors(LAMBDA_M)
    assert two_pi.dtype == inv_lambda.dtype == np.float32
    x = torch.linspace(-0.3, 0.3, 1001)
    assert torch.equal(x.clone().mul_(2 * np.pi), x * torch.tensor(two_pi))
    # the reciprocal PyTorch multiplies by on CUDA: 1 over the scalar cast to float32
    assert torch.ones(()).div_(LAMBDA_M).item() == float(inv_lambda)


def test_the_steering_kernel_is_keyed_for_the_build_and_keeps_accurate_math():
    lib = _build.library_path("steering_phases")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("steering_phases-") and lib.suffix == ".so"
    source = (_build.CSRC_DIR / "steering_phases.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in source.splitlines())
    assert "sincosf(" in code and "__sincosf" not in code and "__sinf" not in code
    assert not any("fast" in flag for flag in _build.NVCC_FLAGS)
