"""TDM-MIMO virtual-array reformat (JAX: ``processors/virtual_array.py``).

The TDM chirp order within a frame is ``chirp = loop * cfgs_per_loop + cfg``,
so the reference's per-config gather collapses to a reshape and a move of
one axis.  Virtual channel ``v = cfg * num_rx + rx``.
"""

from __future__ import annotations

import torch


def reformat(adc_cube: torch.Tensor, *, num_rx: int, cfgs_per_loop: int) -> torch.Tensor:
    """``[..., rx, sample, loops*cfgs] -> [..., cfgs*rx, sample, loops]``."""
    *batch, _, ns, nc = adc_cube.shape
    loops = nc // cfgs_per_loop
    x = adc_cube[..., :num_rx, :, :].reshape(*batch, num_rx, ns, loops,
                                             cfgs_per_loop)
    x = torch.movedim(x, -1, -4)  # [..., cfg, rx, sample, loop]
    return x.reshape(*batch, cfgs_per_loop * num_rx, ns, loops)
