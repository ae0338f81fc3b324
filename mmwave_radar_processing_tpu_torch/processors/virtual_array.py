"""TDM-MIMO virtual-array reformat (JAX: ``processors/virtual_array.py``).

The TDM chirp order within a frame is ``chirp = loop * cfgs_per_loop + cfg``,
so the reference's per-config gather collapses to a reshape and a move of
one axis.  Virtual channel ``v = cfg * num_rx + rx``.
"""

from __future__ import annotations

import torch

from mmwave_radar_processing_tpu_torch.config import RadarConfig
from mmwave_radar_processing_tpu_torch.processors.base import (
    Processor,
    as_complex64,
    resolve_device,
)


def reformat(adc_cube: torch.Tensor, *, num_rx: int, cfgs_per_loop: int) -> torch.Tensor:
    """``[..., rx, sample, loops*cfgs] -> [..., cfgs*rx, sample, loops]``."""
    *batch, _, ns, nc = adc_cube.shape
    loops = nc // cfgs_per_loop
    x = adc_cube[..., :num_rx, :, :].reshape(*batch, num_rx, ns, loops,
                                             cfgs_per_loop)
    x = torch.movedim(x, -1, -4)  # [..., cfg, rx, sample, loop]
    return x.reshape(*batch, cfgs_per_loop * num_rx, ns, loops)


class VirtualArrayReformatter(Processor):
    """Object facade matching the reference's ``VirtualArrayReformatter`` API."""

    def __init__(self, config: RadarConfig, *, device, **kwargs):
        super().__init__(config)
        self.device = resolve_device(device)
        self.chirp_cfgs_per_loop = self.config.chirp_cfgs_per_loop
        self.adc_samples_per_chirp = self.config.num_adc_samples

    def process(self, adc_cube, **kwargs) -> torch.Tensor:
        """Reformat one frame (or a batch with leading axes) of raw ADC data.

        Takes numpy or a tensor of any complex width; returns complex64 on
        the processor's device.
        """
        return reformat(
            as_complex64(adc_cube, self.device),
            num_rx=self.config.num_rx_antennas,
            cfgs_per_loop=self.chirp_cfgs_per_loop,
        )
