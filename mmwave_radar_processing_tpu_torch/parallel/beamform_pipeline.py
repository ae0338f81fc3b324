"""Synthetic-aperture beamforming over a recording, whole or in batches (JAX: ``parallel/beamform_pipeline.py``).

The JAX package runs a ``lax.scan`` whose carry is the ring buffer of the
last ``F`` frames and velocities.  Frame ``t``'s buffer holds frames
``t-F+1 ... t``, zero frames and velocities before the start.  Here the
frames of a call are put behind the ``F-1`` frames that came before them
and cut into windows (``unfold``): every frame's gate, chained geometry and
steering phases ``[T, A, E]`` at once, then one batched complex GEMM
``[T, ns, E] @ [T, E, A]`` and the windowed range DFT.  The DFT acts on
the samples and the element sum on the elements, so they commute: where a
frame has fewer selected chirps ``C`` than the grid has directions ``A``,
the DFT is taken once per frame on its ``C`` chirps before the apertures
are cut (``T+F-1`` frames a call, ``8 ns^2 C`` operations a frame in place
of ``8 ns^2 A``), and the product yields the range spectrum; otherwise it is
taken of the product's ``[T, ns, A]`` beams.  The choice is made from these
shapes when the pipeline is built (``range_dft_first``).  A zero velocity
fails the gate (every ``min_vel`` bound is compared with ``|v|``, and a zero
direction has cosine 0), so the first ``F-1`` outputs of a recording are
zero with ``ok`` False, as in the scan.

A recording too long for one call streams through in batches: a call given
an :class:`ApertureState` (the last ``F-1`` selected frames, raw, and velocities,
:meth:`SyntheticAperturePipeline.init_state` at the start) returns the
state after its frames beside its outputs, and batches of any size give
the outputs of one call over the whole recording.  Without a state a call
starts from zero frames and returns its outputs alone.

``output="depth"`` returns the plotter's depth map of every frame in place
of the magnitude cube (:func:`~mmwave_radar_processing_tpu_torch.processors.synthetic_array.depth_map`):
the strongest range bin per direction, ``-1`` below the floor or where the
gate fails, and that direction's peak magnitude.

The gate, the geometry, the phases and the depth map are
``processors.synthetic_array``'s functions.  On the GPU the steering phases
are one hand-written kernel (``csrc/steering_phases.cu``), which writes
each phase once where the plain version made four passes over the angles;
the product and the range DFT are cuBLAS GEMMs, as the JAX package leaves
them to XLA.  Precision is full float32 with TF32 off.  The stages are
``mmw.sa.*`` spans inside ``mmw.sa`` (``utils/profiling.annotate``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.ops import dft, windows
from mmwave_radar_processing_tpu_torch.parallel.pipeline import set_full_fp32
from mmwave_radar_processing_tpu_torch.parallel.point_stages import check_planes
from mmwave_radar_processing_tpu_torch.processors.base import resolve_device
from mmwave_radar_processing_tpu_torch.processors.synthetic_array import (
    chained_geometry,
    depth_map,
    steering_phases,
    velocity_gate,
)
from mmwave_radar_processing_tpu_torch.utils.profiling import annotate, timed_builder

OUTPUTS = ("magnitude", "depth")


class ApertureState(NamedTuple):
    """What a batch hands the next: the aperture's last ``F-1`` frames, oldest first."""

    adc: torch.Tensor  # [F-1, ns, C] complex64: the selected receiver and chirps, raw samples
    vel: torch.Tensor  # [F-1, 3] float32


class ApertureDepth(NamedTuple):
    """The depth head's outputs of ``T`` frames over ``A = n_az * n_el`` directions (az major)."""

    depth_bin: torch.Tensor  # [T, A] int32: -1 below the floor or where the gate fails
    peak: torch.Tensor  # [T, A] float32: the largest magnitude over range
    ok: torch.Tensor  # [T] bool: the velocity gate


class SyntheticAperturePipeline(nn.Module):
    """``(raw_re, raw_im [T, rx, ns, nc], vels [T, 3][, state]) -> outputs[, state]``.

    The frames are one recording in time order.  ``output="magnitude"``
    gives ``(mag [T, ns, n_az, n_el], ok [T])``, magnitudes zero where the
    velocity gate rejects the aperture (the reference's empty return);
    ``output="depth"`` gives an :class:`ApertureDepth`.  Build it with
    :func:`build_synthetic_aperture_pipeline`.
    """

    def __init__(self, cfg: RadarConfig, *, receiver_idx: int, chirp_cfg_idx: int,
                 num_frames: int, stride: int, az_angle_bins_rad, el_angle_bins_rad,
                 min_vel, max_vel, max_vel_stdev, output: str = "magnitude",
                 depth_floor_db: float = 40.0):
        super().__init__()
        if output not in OUTPUTS:
            raise ValueError(f"output {output!r}, expected one of {OUTPUTS}")
        self.output, self.depth_floor_db = output, float(depth_floor_db)
        self.ns = cfg.num_adc_samples
        self.receiver_idx, self.num_frames = int(receiver_idx), int(num_frames)
        self.frame_shape = (self.ns, cfg.chirps_per_frame)
        self.num_rx = cfg.num_rx_antennas
        az = np.asarray(az_angle_bins_rad, float)
        el = np.asarray(el_angle_bins_rad, float)
        self.n_az, self.n_el = len(az), len(el)
        self.lambda_m = cfg.lambda_m
        self.frame_dt = cfg.frame.periodicity_ms * 1e-3
        # the gate's bounds live on the device: a bound copied from the host at
        # every call would hold the host until the device had drained
        for name, bound in (("min_vel", min_vel), ("max_vel", max_vel),
                            ("max_vel_stdev", max_vel_stdev)):
            self.register_buffer(name, torch.from_numpy(np.array(bound, np.float32)))

        chirp_cfg_idxs = np.tile(np.arange(cfg.frame.start_index, cfg.frame.end_index + 1),
                                 cfg.frame.loops)
        valid_idx = np.flatnonzero(chirp_cfg_idxs == chirp_cfg_idx)[::stride]
        self.register_buffer("valid_idx", torch.from_numpy(valid_idx))
        self.register_buffer("chirp_times_s", torch.from_numpy(
            ((np.arange(cfg.chirps_per_frame - 1, -1, -1) * -cfg.chirp_period_us)[valid_idx]
             * 1e-6).astype(np.float32)))
        th, ph = np.meshgrid(az, el, indexing="ij")
        self.register_buffer("steering", torch.from_numpy(np.stack(
            [np.cos(th) * np.cos(ph), np.sin(th) * np.cos(ph), np.sin(ph)],
            axis=-1).reshape(-1, 3).astype(np.float32)))  # (A, 3)
        self.register_buffer("element_window", torch.from_numpy(
            windows.hamming(num_frames * len(valid_idx))))
        self.register_buffer("rng_dft", dft.to_matrix(
            dft.dft_factors(self.ns, window=np.hanning(self.ns))))
        # the range DFT before the element sum costs 8 ns^2 C a frame, after it 8 ns^2 A
        self.range_dft_first = len(valid_idx) < self.n_az * self.n_el

    def init_state(self) -> ApertureState:
        """The state before a recording's first frame: ``F-1`` zero frames and velocities."""
        device, f = self.rng_dft.device, self.num_frames - 1
        return ApertureState(
            torch.zeros((f, self.ns, len(self.valid_idx)), dtype=torch.complex64, device=device),
            torch.zeros((f, 3), dtype=torch.float32, device=device))

    def _check(self, raw_re, raw_im, vels, state) -> None:
        check_planes(raw_re, raw_im, frame_shape=self.frame_shape,
                     min_planes=self.receiver_idx + 1, device=self.rng_dft.device)
        t = raw_re.shape[0]
        if vels.shape != (t, 3) or not vels.is_floating_point() \
                or vels.device != raw_re.device:
            raise ValueError(f"expected velocities [{t}, 3] on {raw_re.device}, got "
                             f"{vels.dtype} {tuple(vels.shape)} on {vels.device}")
        if state is not None:
            f = self.num_frames - 1
            want = (((f, self.ns, len(self.valid_idx)), torch.complex64), ((f, 3), torch.float32))
            for got, (shape, dtype) in zip(state, want):
                if got.shape != shape or got.dtype != dtype or got.device != raw_re.device:
                    raise ValueError(f"state {got.dtype} {tuple(got.shape)} on {got.device}, "
                                     f"expected {dtype} {shape} on {raw_re.device}")

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor, vels: torch.Tensor,
                state: Optional[ApertureState] = None):
        self._check(raw_re, raw_im, vels, state)
        t, f = raw_re.shape[0], self.num_frames
        with annotate("mmw.sa"):
            with annotate("mmw.sa.window"):
                head = self.init_state() if state is None else state
                frames = torch.complex(raw_re[:, self.receiver_idx],
                                       raw_im[:, self.receiver_idx])[:, :, self.valid_idx]
                # the ring buffer of every frame: the F-1 frames before the call, then windows
                ring = torch.cat([head.adc, frames])  # [T+F-1, ns, C]
                vel_ring = torch.cat([head.vel, vels.to(torch.float32)])  # [T+F-1, 3]
                after = ApertureState(ring[t:].clone(), vel_ring[t:].clone())
                if self.range_dft_first:
                    with annotate("mmw.sa.range_dft"):
                        ring = self.rng_dft.transpose(0, 1) @ ring  # each frame's spectrum
                data = ring.unfold(0, f, 1).permute(0, 1, 3, 2).reshape(t, self.ns, -1)
                data = data * self.element_window  # [T, ns, E], element e = frame*C + chirp
            with annotate("mmw.sa.gate"):
                vel = vel_ring.unfold(0, f, 1).transpose(1, 2)  # [T, F, 3]
                ok = velocity_gate(vel, self.min_vel, self.max_vel, self.max_vel_stdev)
                geometry = chained_geometry(vel, self.chirp_times_s, self.frame_dt)  # [T, F, 3, C]
                positions = geometry.transpose(1, 2).reshape(t, 3, -1)  # [T, 3, E]
            with annotate("mmw.sa.phases"):
                phases = steering_phases(self.steering, positions, self.lambda_m)  # [T, A, E]
            with annotate("mmw.sa.product"):
                beamformed = data @ phases.transpose(1, 2)  # [T, ns, A]
                del phases
            with annotate("mmw.sa.range_dft"):
                if not self.range_dft_first:
                    beamformed = self.rng_dft.transpose(0, 1) @ beamformed
                mag = dft.cabs(beamformed)  # [T, ns, A]
                if self.output == "magnitude":
                    out = (torch.where(ok[:, None, None], mag, 0.0).reshape(
                        t, self.ns, self.n_az, self.n_el), ok)
            if self.output == "depth":
                with annotate("mmw.sa.depth"):
                    depth_bin, peak = depth_map(mag, self.depth_floor_db)
                    out = ApertureDepth(
                        torch.where(ok[:, None], depth_bin, -1).to(torch.int32),
                        torch.where(ok[:, None], peak, 0.0), ok)
            return out if state is None else (out, after)


@timed_builder("synthetic_aperture")
def build_synthetic_aperture_pipeline(
    cfg: RadarConfig,
    *,
    receiver_idx: int = 0,
    chirp_cfg_idx: int = 0,
    num_frames: int = 3,
    stride: int = 1,
    az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 60)),
    el_angle_bins_rad=np.array([0.0]),
    min_vel=np.array([0.15, 0.0, 0.0]),
    max_vel=np.array([0.3, 0.05, 0.05]),
    max_vel_stdev=np.array([0.1, 0.1, 0.1]),
    output: str = "magnitude",
    depth_floor_db: float = 40.0,
    device,
) -> SyntheticAperturePipeline:
    """Build ``(raw_re [T, ...], raw_im [T, ...], vels [T, 3][, state]) -> outputs[, state]`` on ``device``.

    The signature mirrors the JAX package's (whose defaults differ from the
    processor's: ``num_frames=3`` here, 2 there), plus ``output``
    (``"magnitude"``: ``(mag, ok)``; ``"depth"``: :class:`ApertureDepth`)
    and the depth map's ``depth_floor_db``.  Calls :func:`set_full_fp32`.
    """
    device = resolve_device(device)
    set_full_fp32()
    return SyntheticAperturePipeline(
        cfg, receiver_idx=receiver_idx, chirp_cfg_idx=chirp_cfg_idx,
        num_frames=num_frames, stride=stride, az_angle_bins_rad=az_angle_bins_rad,
        el_angle_bins_rad=el_angle_bins_rad, min_vel=min_vel, max_vel=max_vel,
        max_vel_stdev=max_vel_stdev, output=output,
        depth_floor_db=depth_floor_db).to(device)
