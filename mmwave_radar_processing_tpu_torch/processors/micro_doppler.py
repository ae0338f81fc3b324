"""Micro-Doppler spectrogram: per-frame Doppler column and a shift-register history (JAX: ``processors/micro_doppler.py``).

The per-frame 2D FFT and range-gated max is a plain function; the
``num_frames_history``-column spectrogram is an explicit state threaded
through :meth:`MicroDopplerProcessor.step`.  Each column depends only on its
own frame, so a recording is processed at once: all columns, then the
history after every frame as one gather (:func:`spectrogram_stack`), equal
to the frame-by-frame shift register.
"""

from __future__ import annotations

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    resolve_device,
)


def micro_doppler_column(rx_slice: torch.Tensor, range_mask: torch.Tensor) -> torch.Tensor:
    """Spectrogram column: the max over the gated range bins of the RD magnitude.

    Args:
        rx_slice: ``[..., samples, chirps]`` complex64, one RX antenna.
        range_mask: ``[samples]`` bool, the range bins to keep.

    Returns:
        ``[..., chirps]`` float32; ``-inf`` where the mask is empty.  No
        windows, and only the Doppler axis is fftshifted (reference :97-107).
    """
    resp = torch.abs(torch.fft.fftshift(torch.fft.fft2(rx_slice, dim=(-2, -1)), dim=-1))
    gated = torch.where(range_mask[:, None], resp, float("-inf"))
    return torch.amax(gated, dim=-2)


def shift_in_column(history: torch.Tensor, column: torch.Tensor) -> torch.Tensor:
    """Shift-register update: the newest column at index 0 (reference :110-113)."""
    return torch.cat([column[:, None], history[:, :-1]], dim=1)


def spectrogram_stack(columns: torch.Tensor, num_frames_history: int) -> torch.Tensor:
    """The history after each of ``T`` frames from a zeroed start: ``[T, V]`` -> ``[T, V, H]``.

    History ``t`` holds columns ``t, t-1, ..., t-H+1``, zeros before the
    first frame: a gather over the zero-padded columns, the same values as
    ``T`` calls of :func:`shift_in_column` from :meth:`MicroDopplerProcessor.init_state`.
    """
    t, h = columns.shape[0], num_frames_history
    seq = torch.nn.functional.pad(columns, (0, 0, h, 0))  # [H + T, V], zeros first
    idx = (h + torch.arange(t, device=columns.device)[:, None]
           - torch.arange(h, device=columns.device)[None, :])
    return seq[idx].transpose(1, 2)


class MicroDopplerProcessor(Processor):
    """Velocity-vs-time spectrogram processor with explicit state, on an explicit ``device``."""

    def __init__(self, config: RadarConfig, target_ranges=(0.0, 1.0),
                 num_frames_history: int = 20, *, device, **kwargs):
        super().__init__(config)
        self.device = resolve_device(device)
        target_ranges = np.asarray(target_ranges, dtype=float)
        self.vel_bins = grids.vel_bins(self.config)
        self.range_bins = grids.range_bins(self.config, variant="eps")
        self.num_frames_history = num_frames_history
        self.target_ranges = target_ranges
        self.range_mask = np.logical_and(self.range_bins >= target_ranges[0],
                                         self.range_bins <= target_ranges[1])
        self._range_mask_t = torch.from_numpy(self.range_mask).to(self.device)
        self.time_bins = grids.time_bins(self.config, num_frames_history)
        self.micro_doppler_resp = self.init_state()

    def init_state(self) -> torch.Tensor:
        """Zeroed spectrogram ``[vel_bins, num_frames_history]`` float32."""
        return torch.zeros((self.vel_bins.shape[0], self.num_frames_history),
                           dtype=torch.float32, device=self.device)

    def state_from_jax(self, history: np.ndarray) -> torch.Tensor:
        """A spectrogram state given as numpy (e.g. a JAX processor's), on this device."""
        history = np.array(history, np.float32)
        want = (len(self.vel_bins), self.num_frames_history)
        if history.shape != want:
            raise ValueError(f"state shape {history.shape}, expected {want}")
        return torch.from_numpy(history).to(self.device)

    def step(self, state: torch.Tensor, adc_cube, rx_idx: int = 0):
        """Functional update: ``(state, frame) -> (state, state)``."""
        cube = as_complex64(adc_cube, self.device)
        col = micro_doppler_column(cube[..., rx_idx, :, :], self._range_mask_t)
        new_state = shift_in_column(state, col)
        return new_state, new_state

    def scan(self, adc_frames, rx_idx: int = 0):
        """Process ``[frames, rx, samples, chirps]`` at once.

        Returns the final state and the per-frame spectrogram stack
        ``[frames, vel_bins, history]``, as a loop of :meth:`step` from
        :meth:`init_state` gives them.
        """
        frames = as_complex64(adc_frames, self.device)
        cols = micro_doppler_column(frames[:, rx_idx], self._range_mask_t)
        stack = spectrogram_stack(cols, self.num_frames_history)
        return (stack[-1] if len(stack) else self.init_state()), stack

    def process(self, adc_cube, rx_idx: int = 0, **kwargs) -> torch.Tensor:
        """Stateful one-frame update (reference-compatible mutating API)."""
        self.micro_doppler_resp, out = self.step(self.micro_doppler_resp, adc_cube,
                                                 rx_idx=rx_idx)
        return out

    def reset(self) -> None:
        self.micro_doppler_resp = self.init_state()
        super().reset()
