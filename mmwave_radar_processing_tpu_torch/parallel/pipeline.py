"""Frame-batched point-cloud pipeline: raw cubes -> point clouds (JAX: ``parallel/pipeline.py``).

The port of ``build_point_cloud_pipeline`` with the ``union`` dataflow, the
main path of the system.  Per frame:

1. windowed range DFT of the AoA antenna union (plus channel 0), with the
   virtual-array reformat folded into the channel selection -> ``R``
   (``point_stages.antenna_union``, ``ops.dft.range_dft_input``);
2. Doppler DFT of channel 0 and its magnitude -> the CFAR map;
3. counting OS-CFAR 2D detection and
4. compaction of the first ``max_dets`` detections, row-major (on a GPU one
   hand-written CUDA kernel does both: ``ops/cfar.os_2d_detect_compact``);
5. the shared angle head (``point_stages.AngleHead``) on the union: the
   detections' angles and FLU points, invalid rows zero.

Under ``torch.profiler`` a call is the span ``mmw.pc``, split into
``mmw.pc.spectral`` (1-2), ``mmw.pc.cfar`` (3-4) and ``mmw.pc.aoa`` (5).

The pipeline's state is its constants (DFT matrices, angle bins, antenna
layout, CFAR geometry); it has no learned weights and uses no randomness.
Precision is full float32 with TF32 off (:func:`set_full_fp32`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.ops import dft
from mmwave_radar_processing_tpu_torch.ops.cfar import os_2d_detect_compact
from mmwave_radar_processing_tpu_torch.parallel.mesh import frame_slice
from mmwave_radar_processing_tpu_torch.parallel.point_stages import (
    AngleHead,
    antenna_union,
    check_planes,
)
from mmwave_radar_processing_tpu_torch.processors.base import resolve_device
from mmwave_radar_processing_tpu_torch.utils.profiling import annotate, timed_builder

DEFAULT_CFAR_PARAMS = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)

#: complex DFT buffers and the JAX ``(cos, sin)`` constant pair each is built from
_FACTOR_KEYS = {
    "rng_dft": ("rng_cos", "rng_sin"),
    "dop_dft": ("dop_cos", "dop_sin"),
    "head.az_dft": ("az_cos", "az_sin"),
    "head.el_dft": ("el_cos", "el_sin"),
}
#: structural constants: checked against the pipeline's own, never overwritten
_LAYOUT_KEYS = ("union_idx", "az_pos", "el_pos")


class PointCloudBatch(NamedTuple):
    points: torch.Tensor  # float32 [B, K, 4]
    valid: torch.Tensor  # bool [B, K]
    count: torch.Tensor  # int32 [B]


def set_full_fp32() -> None:
    """Full float32 matmuls: TF32 off for cuBLAS and cuDNN, precision "highest".

    These are process-wide PyTorch settings.  The pipeline's discrete
    decisions (CFAR comparisons, angle argmax) are held to a float32
    reference, and TF32 keeps only about three decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class PointCloudPipeline(nn.Module):
    """``(raw_re, raw_im) float32 [B, rx, ns, nc] -> PointCloudBatch``.

    With ``reformat_input=False`` the planes are already reformatted virtual
    cubes ``[B, virtual channels, ns, loops]``.  An empty antenna subset
    gives zero angles on that axis.  Build it with
    :func:`build_point_cloud_pipeline`, which checks the options and places
    it on a device.
    """

    def __init__(
        self,
        cfg: RadarConfig,
        *,
        az_antenna_idxs: Sequence[int],
        el_antenna_idxs: Sequence[int],
        cfar_params: dict,
        max_dets: int,
        num_angle_bins: int,
        shift_az_resp: bool,
        shift_el_resp: bool,
        reformat_input: bool = True,
    ):
        super().__init__()
        ns, loops = cfg.num_adc_samples, cfg.frame.loops
        self.num_rx, self.cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
        self.reformat_input = reformat_input
        self.frame_shape = (ns, loops * self.cpl) if reformat_input else (ns, loops)
        self.cfar_params = dict(cfar_params)
        self.max_dets = max_dets
        layout = antenna_union(az_antenna_idxs, el_antenna_idxs,
                               reformat_input=reformat_input, num_rx=self.num_rx)
        self.union_idx, self.min_planes = layout.union_idx, layout.min_planes
        self.ch0_pos, self.aoa_start = layout.ch0_pos, layout.aoa_start

        rng_factors, dop_factors = dft.range_doppler_factors(ns, loops)
        self.register_buffer("rng_dft", dft.to_matrix(rng_factors))
        self.register_buffer("dop_dft", dft.to_matrix(dop_factors))
        self.register_buffer("chans", torch.from_numpy(layout.chans.astype(np.int64)))
        self.head = AngleHead(cfg, az_pos=layout.az_pos, el_pos=layout.el_pos,
                              num_angle_bins=num_angle_bins, shift_az_resp=shift_az_resp,
                              shift_el_resp=shift_el_resp)

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor) -> PointCloudBatch:
        check_planes(raw_re, raw_im, frame_shape=self.frame_shape,
                     min_planes=self.min_planes, device=self.rng_dft.device)
        with annotate("mmw.pc"):
            with annotate("mmw.pc.spectral"):
                R = dft.range_dft_input(torch.complex(raw_re, raw_im), self.chans,
                                        self.rng_dft, reformat_input=self.reformat_input,
                                        num_rx=self.num_rx, cfgs_per_loop=self.cpl)
                rd0 = torch.matmul(R[:, self.ch0_pos], self.dop_dft)  # [B, W, V]
                mag = dft.cabs(rd0)
            with annotate("mmw.pc.cfar"):
                r_i, v_i, valid, count = os_2d_detect_compact(
                    mag, self.max_dets, **self.cfar_params)
            del mag  # the CFAR map is not held through the angle stage

            with annotate("mmw.pc.aoa"):
                pts = self.head(R[:, self.aoa_start:], self.dop_dft, r_i, v_i, valid)
        return PointCloudBatch(pts, valid, count)


@timed_builder("point_cloud")
def build_point_cloud_pipeline(
    cfg: RadarConfig,
    *,
    az_antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    el_antenna_idxs: Sequence[int] = (9, 8, 5, 4),
    cfar_params: Optional[dict] = None,
    max_dets: int = 128,
    num_angle_bins: int = 64,
    shift_az_resp: bool = True,
    shift_el_resp: bool = False,
    reformat_input: bool = True,
    backend: str = "mxu",
    aoa_precision: str = "f32",
    dataflow: str = "union",
    device,
) -> PointCloudPipeline:
    """Build the point-cloud pipeline on ``device`` (``"cpu"`` or ``"cuda[:n]"``).

    The signature mirrors the JAX package's.  Only what the port implements
    is accepted; the rest raises ``ValueError`` rather than running another
    path: ``backend`` is ``"mxu"`` (the DFT-as-matmul formulation),
    ``dataflow`` is ``"union"`` and ``aoa_precision`` is ``"f32"`` (the port
    has no reduced-precision mode; the result is held to the JAX ``"f32"``
    pipeline).  ``reformat_input=False`` takes already reformatted virtual
    cubes ``[B, virtual channels, ns, loops]``; an empty antenna subset gives
    zero angles on its axis.  Calls :func:`set_full_fp32`.
    """
    if backend != "mxu":
        raise ValueError(f"backend={backend!r} is not ported (only 'mxu')")
    if dataflow != "union":
        raise ValueError(f"dataflow={dataflow!r} is not ported (only 'union')")
    if not isinstance(reformat_input, bool):
        raise ValueError(f"reformat_input={reformat_input!r}: expected a bool")
    if aoa_precision != "f32":
        raise ValueError(f"aoa_precision={aoa_precision!r} is not ported: the "
                         "port runs full float32 only ('f32')")
    device = resolve_device(device)
    set_full_fp32()
    pipeline = PointCloudPipeline(
        cfg,
        az_antenna_idxs=az_antenna_idxs,
        el_antenna_idxs=el_antenna_idxs,
        cfar_params=cfar_params or DEFAULT_CFAR_PARAMS,
        max_dets=max_dets,
        num_angle_bins=num_angle_bins,
        shift_az_resp=shift_az_resp,
        shift_el_resp=shift_el_resp,
        reformat_input=reformat_input,
    )
    return pipeline.to(device)


def load_reference_constants(pipeline: PointCloudPipeline,
                             consts: Dict[str, np.ndarray]) -> None:
    """Fill the pipeline's constant buffers from the JAX package's constants.

    ``consts`` holds numpy arrays: the ``(cos, sin)`` factor pairs
    ``rng_cos``/``rng_sin`` and ``dop_cos``/``dop_sin``
    (``ops/mxu.range_doppler_factors``), ``az_cos``/``az_sin`` and
    ``el_cos``/``el_sin`` (``ops/mxu.aoa_factors``), and ``angle_bins``; plus
    the antenna layout ``union_idx``, ``az_pos`` and ``el_pos``
    (``ops/mxu.aoa_union_layout``), which must equal the pipeline's own.
    """
    expected = {k for pair in _FACTOR_KEYS.values() for k in pair}
    expected |= {"angle_bins", *_LAYOUT_KEYS}
    if set(consts) != expected:
        raise ValueError(f"constant names differ: missing "
                         f"{sorted(expected - set(consts))}, unknown "
                         f"{sorted(set(consts) - expected)}")
    layout = {"union_idx": pipeline.union_idx,
              "az_pos": pipeline.head.az_pos.cpu().numpy(),
              "el_pos": pipeline.head.el_pos.cpu().numpy()}
    for key, own in layout.items():
        if not np.array_equal(np.asarray(consts[key]), own):
            raise ValueError(f"{key} {np.asarray(consts[key])} differs from the "
                             f"pipeline's {own}")

    def f32(key):
        return torch.from_numpy(np.array(consts[key], np.float32))

    loaded = {buf: dft.to_matrix((f32(c), f32(s)))
              for buf, (c, s) in _FACTOR_KEYS.items()}
    loaded["head.angle_bins"] = f32("angle_bins")
    with torch.no_grad():
        for buf, value in loaded.items():
            target = pipeline.get_buffer(buf)
            if value.shape != target.shape:
                raise ValueError(f"{buf}: shape {tuple(value.shape)}, pipeline "
                                 f"has {tuple(target.shape)}")
            target.copy_(value)


def shard_pipeline(pipeline, mesh, axis: str = "data"):
    """Run a frame-batched pipeline on this rank's share of every global batch.

    Frames are independent: each rank takes its own frames
    (``mesh.frame_slice`` of the global batch), its outputs stay local, and
    no collective runs on the hot path (JAX ``shard_pipeline``, where XLA
    inserts none).  Returns ``fn(*args, global_batch, **kwargs)``: every
    tensor argument, keyword arguments such as ``gumbel`` included, must
    hold this rank's ``global_batch / axis_size`` frames on its leading axis.
    """
    def wrapped(*args, global_batch: int, **kwargs):
        share = frame_slice(mesh, global_batch, axis)
        local = share.stop - share.start
        for name, value in [*enumerate(args), *kwargs.items()]:
            if isinstance(value, torch.Tensor) and value.shape[:1] != (local,):
                raise ValueError(f"argument {name}: leading axis {tuple(value.shape[:1])} is "
                                 f"not this rank's share {local} of the global batch "
                                 f"{global_batch}")
        return pipeline(*args, **kwargs)

    return wrapped
