"""Analytic FLOP and HBM-byte cost models of the bench metrics (JAX: ``utils/roofline.py``).

The models count the work of the algorithm, not of one implementation of
it, so they stay the yardstick when a stage is fused or moved to another
kernel: a DFT is ``8 * B * N * M`` FLOPs however it runs.  The formulas are
the JAX package's, unchanged.

Conventions:

- A split-complex DFT along an axis is four real ``[B, N] x [N, M]`` matmuls:
  ``8 * B * N * M`` FLOPs.
- Byte counts are *compulsory* HBM traffic only: the pipeline's input read
  once and its final output written once.  Intermediates are not counted,
  so real traffic is at least the model and the reported HBM utilization is
  a lower bound.
- MFU is measured against the float32 peak outside the tensor cores (the
  port runs float32 with TF32 off).

The peaks are NVIDIA's published figures for one H100 SXM at its full
700 W power limit: 67 TFLOP/s float32 (no tensor cores) and 3.35 TB/s of
HBM3.  A card set to a lower power limit reaches less.
"""

from __future__ import annotations

from dataclasses import dataclass

from mmwave_radar_processing_tpu_torch.config import RadarConfig

#: float32 peak of one H100 SXM outside the tensor cores, TFLOP/s
DEFAULT_PEAK_F32_TFLOPS = 67.0
#: HBM3 bandwidth of one H100 SXM, GB/s
DEFAULT_PEAK_HBM_GBS = 3350.0


@dataclass(frozen=True)
class CostModel:
    """Per-frame cost of one benchmark pipeline."""

    flops_per_frame: float
    bytes_per_frame: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops_per_frame / max(self.bytes_per_frame, 1.0)


def _dft_flops(batch: int, n_in: int, n_out: int) -> float:
    """Split-complex DFT as four real matmuls."""
    return 8.0 * batch * n_in * n_out


def _raw_input_bytes(cfg: RadarConfig) -> float:
    """Two float32 planes of the raw ``[rx, ns, nc]`` cube."""
    return 2.0 * 4 * cfg.num_rx_antennas * cfg.num_adc_samples * cfg.chirps_per_frame


def pointcloud_cost(
    cfg: RadarConfig,
    *,
    max_dets: int = 128,
    num_angle_bins: int = 64,
    num_train=(5, 5),
    num_guard=(3, 2),
    n_az: int = 4,
    n_el: int = 4,
) -> CostModel:
    """RD DFTs + counting OS-CFAR + per-detection AoA + cartesian points."""
    v, ns, k = cfg.num_virtual_antennas, cfg.num_adc_samples, cfg.frame.loops
    flops = _dft_flops(v * k, ns, ns)  # windowed range DFT
    flops += _dft_flops(v * ns, k, k)  # Doppler DFT
    flops += 4.0 * ns * k  # magnitude of antenna 0 + squared terms
    # counting CFAR: each CUT compares every training cell and accumulates
    win = (2 * (num_train[0] + num_guard[0]) + 1) * (
        2 * (num_train[1] + num_guard[1]) + 1
    ) - (2 * num_guard[0] + 1) * (2 * num_guard[1] + 1)
    flops += 3.0 * ns * k * win
    # AoA: zero-padded angle DFT per detection, az + el sets
    flops += _dft_flops(max_dets, n_az, num_angle_bins)
    flops += _dft_flops(max_dets, n_el, num_angle_bins)
    flops += 30.0 * max_dets  # |.|^2, argmax, trig, cartesian
    out_bytes = 4.0 * max_dets * 6  # points(4) + valid + count
    return CostModel(flops, _raw_input_bytes(cfg) + out_bytes)


def capon_cost(
    cfg: RadarConfig, *, n_ant: int = 4, num_angle_bins: int = 64
) -> CostModel:
    """Range DFT + per-range-bin covariance + real-embedded Cholesky solve."""
    ns, k, m = cfg.num_adc_samples, cfg.frame.loops, num_angle_bins
    a2 = 2 * n_ant  # real embedding dimension
    flops = _dft_flops(n_ant * k, ns, ns)  # windowed range DFT
    flops += ns * 8.0 * n_ant * n_ant * k  # covariance X X^H (4 matmuls)
    flops += ns * (a2**3) / 3.0  # batched Cholesky
    flops += ns * 2.0 * (a2**2) * m  # two triangular solves for all steerings
    flops += ns * 2.0 * a2 * m  # denominator reduction + reciprocal
    out_bytes = 4.0 * ns * m
    return CostModel(flops, _raw_input_bytes(cfg) + out_bytes)


def bartlett_cost(
    cfg: RadarConfig, *, n_ant: int = 4, num_angle_bins: int = 64
) -> CostModel:
    """Range DFT + fused steering matmuls + snapshot power reduction."""
    ns, k, m = cfg.num_adc_samples, cfg.frame.loops, num_angle_bins
    flops = _dft_flops(n_ant * k, ns, ns)
    flops += ns * 8.0 * m * n_ant * k  # four steering matmuls per range bin
    flops += ns * 3.0 * m * k  # |s|^2 + mean over snapshots
    out_bytes = 4.0 * ns * m
    return CostModel(flops, _raw_input_bytes(cfg) + out_bytes)


def analytic_cost(metric: str, cfg: RadarConfig, **kw) -> "CostModel | None":
    """The model of a bench metric; None when no model exists."""
    if metric == "pointcloud":
        return pointcloud_cost(cfg, **kw)
    if metric == "capon":
        return capon_cost(cfg, **kw)
    if metric == "bartlett":
        return bartlett_cost(cfg, **kw)
    return None


def classify_bound(
    tflops: float,
    gbs: float,
    *,
    peak_tflops: float = DEFAULT_PEAK_F32_TFLOPS,
    peak_gbs: float = DEFAULT_PEAK_HBM_GBS,
) -> str:
    """'compute' / 'bandwidth' / 'dispatch' from achieved vs peak rates.

    If neither engine exceeds 10% of peak the pipeline is dominated by
    dispatch/launch/queue overheads rather than either hardware roof.
    """
    mfu = tflops / peak_tflops
    hbm = gbs / peak_gbs
    if max(mfu, hbm) < 0.10:
        return "dispatch"
    if hbm > 1.0 >= mfu:
        # nominal bytes exceed physical bandwidth: the byte count bills
        # reused operands as HBM traffic
        return "bandwidth (nominal bytes; on-chip reuse)"
    return "compute" if mfu >= hbm else "bandwidth"
