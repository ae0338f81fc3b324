"""Frame-batched Capon / Bartlett heatmap pipeline (JAX: ``parallel/capon_pipeline.py``).

Raw ADC cubes in, range-azimuth power maps out.  Per frame:

1. the windowed range DFT of the selected antennas (``ops.dft.range_dft_input``:
   the virtual-array reformat folded into the channel selection, or the
   selected channels of an already reformatted cube) -> complex
   ``[B, A, W, K]`` (range bins ``W``, chirps ``K`` as snapshots);
2. per (frame, range bin) the snapshot covariance and the Capon (loaded
   complex Cholesky) or Bartlett spectrum on the reference angle grid
   (``ops.beamform``; the hand-written CUDA kernel on a GPU) ->
   float32 ``[B, W, M]``.

The "Capon/Bartlett beamforming azimuth-elevation heatmaps (virtual array,
6843 ods)" configuration of ``BASELINE.json``; ``bench.py --metric capon``
and ``--metric bartlett`` time the JAX counterpart.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import beamform as bf, dft
from mmwave_radar_processing_tpu_torch.ops.windows import hanning
from mmwave_radar_processing_tpu_torch.parallel.pipeline import (
    resolve_device,
    set_full_fp32,
)

METHODS = ("capon", "bartlett")


class CaponPipeline(nn.Module):
    """``(raw_re, raw_im) float32 [B, rx, ns, nc] -> float32 [B, ns, num_angle_bins]``.

    Build it with :func:`build_capon_pipeline`, which checks the options and
    places it on a device.  Its state is constant buffers: the range DFT
    matrix ``rng_dft``, the steering matrix ``steering`` and the channel
    indices ``chans``.
    """

    def __init__(self, cfg: RadarConfig, *, antenna_idxs: Sequence[int],
                 num_angle_bins: int, method: str, loading: float,
                 reformat_input: bool):
        super().__init__()
        ns = cfg.num_adc_samples
        self.ns, self.num_angle_bins = ns, num_angle_bins
        self.num_rx, self.cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
        self.chirps = cfg.chirps_per_frame
        self.method, self.loading = method, loading
        self.reformat_input = reformat_input
        self.antenna_idxs = tuple(int(v) for v in antenna_idxs)
        # float32 window, as the JAX pipeline builds it (the point-cloud
        # pipeline's factors use a float64 one)
        self.register_buffer("rng_dft", dft.to_matrix(
            dft.dft_factors(ns, window=hanning(ns))))
        self.register_buffer("steering", bf.steering_ula(
            grids.phase_shift_bins(num_angle_bins), len(self.antenna_idxs)))
        self.register_buffer("chans", torch.tensor(self.antenna_idxs,
                                                   dtype=torch.int64))

    def _check_inputs(self, raw_re: torch.Tensor, raw_im: torch.Tensor) -> None:
        ok = raw_re.shape == raw_im.shape and raw_re.dim() == 4 \
            and raw_re.shape[2] == self.ns
        if self.reformat_input:
            ok = ok and raw_re.shape[1] >= self.num_rx \
                and raw_re.shape[3] == self.chirps
            want = f"[B, >={self.num_rx}, {self.ns}, {self.chirps}]"
        else:
            ok = ok and raw_re.shape[1] > max(self.antenna_idxs) \
                and raw_re.shape[3] >= 1
            want = f"[B, >{max(self.antenna_idxs)}, {self.ns}, K]"
        if not ok:
            raise ValueError(f"expected planes {want}, got {tuple(raw_re.shape)} "
                             f"and {tuple(raw_im.shape)}")
        for plane in (raw_re, raw_im):
            if plane.dtype != torch.float32:
                raise TypeError(f"expected float32 planes, got {plane.dtype}")
            if plane.device != self.rng_dft.device:
                raise ValueError(f"input on {plane.device}, pipeline on "
                                 f"{self.rng_dft.device}")

    def range_dft(self, raw_re: torch.Tensor, raw_im: torch.Tensor) -> torch.Tensor:
        """Windowed range DFT of the selected channels: complex ``[B, A, ns, K]``."""
        return dft.range_dft_input(torch.complex(raw_re, raw_im), self.chans, self.rng_dft,
                                   reformat_input=self.reformat_input, num_rx=self.num_rx,
                                   cfgs_per_loop=self.cpl)

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor) -> torch.Tensor:
        self._check_inputs(raw_re, raw_im)
        rng = self.range_dft(raw_re, raw_im)
        if self.method == "capon":
            return bf.capon_power(rng, self.steering, loading=self.loading)
        return bf.bartlett_power(rng, self.steering)


def build_capon_pipeline(
    cfg: RadarConfig,
    *,
    antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    num_angle_bins: int = 64,
    method: str = "capon",
    loading: float = 1e-2,
    reformat_input: bool = True,
    bartlett_backend: Optional[str] = None,
    capon_method: str = "auto",
    device,
) -> CaponPipeline:
    """Build the Capon or Bartlett heatmap pipeline on ``device`` (``"cpu"`` or ``"cuda[:n]"``).

    The signature mirrors the JAX package's.  ``method`` is ``"capon"``
    (MVDR, relative diagonal ``loading``) or ``"bartlett"``.
    ``reformat_input=False`` takes already reformatted virtual cubes
    ``[B, n_virtual, ns, loops]``.  ``capon_method`` and ``bartlett_backend``
    choose TPU formulations in the JAX package; here the device decides (the
    plain version on the CPU, the CUDA kernel on a GPU), so only their
    defaults, ``"auto"`` and ``None``, are accepted.  Calls
    :func:`set_full_fp32`.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}, expected one of {METHODS}")
    if capon_method != "auto":
        raise ValueError(f"capon_method={capon_method!r} is not ported: the "
                         "device decides ('auto')")
    if bartlett_backend is not None:
        raise ValueError(f"bartlett_backend={bartlett_backend!r} is not ported: "
                         "the device decides (None)")
    device = resolve_device(device)
    set_full_fp32()
    pipeline = CaponPipeline(cfg, antenna_idxs=antenna_idxs,
                             num_angle_bins=num_angle_bins, method=method,
                             loading=loading, reformat_input=reformat_input)
    return pipeline.to(device)


def load_capon_constants(pipeline: CaponPipeline,
                         consts: Dict[str, np.ndarray]) -> None:
    """Fill the pipeline's constant buffers from the JAX package's constants.

    ``consts`` holds numpy arrays made by the JAX package's functions: the
    range DFT factors ``rng_cos``/``rng_sin`` (``mxu.dft_factors(ns,
    window=windows.hanning(ns))``, ``(ns, ns)``) and the steering planes
    ``steer_re``/``steer_im`` (``beamform.steering_ula(
    grids.phase_shift_bins(M), A)``, ``(A, M)``).  Names and shapes are
    checked.
    """
    ns, m = pipeline.ns, pipeline.num_angle_bins
    a = len(pipeline.antenna_idxs)
    shapes = {"rng_cos": (ns, ns), "rng_sin": (ns, ns), "steer_re": (a, m),
              "steer_im": (a, m)}
    if set(consts) != set(shapes):
        raise ValueError(f"constant names differ: missing "
                         f"{sorted(set(shapes) - set(consts))}, unknown "
                         f"{sorted(set(consts) - set(shapes))}")
    f32 = {}
    for key, shape in shapes.items():
        value = np.array(consts[key], np.float32)
        if value.shape != shape:
            raise ValueError(f"{key}: shape {value.shape}, expected {shape}")
        f32[key] = torch.from_numpy(value)
    with torch.no_grad():
        pipeline.rng_dft.copy_(dft.to_matrix((f32["rng_cos"], f32["rng_sin"])))
        pipeline.steering.copy_(torch.complex(f32["steer_re"], f32["steer_im"]))
