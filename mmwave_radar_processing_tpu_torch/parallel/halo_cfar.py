"""Sharded CFAR with a guard-and-train halo exchange (JAX: ``parallel/halo_cfar.py``).

When the range (or Doppler) axis is split over ranks, every cell under test
near a shard boundary needs ``num_train + num_guard`` cells of the
neighbouring shard.  Each rank sends its edges to both neighbours
(:func:`.collectives.from_left`, :func:`.collectives.from_right`), puts the
halos it receives around its shard, runs the unsharded op on that, and
crops back.  The result is bit-equal to the unsharded op on the same device.

Edge ranks keep the unsharded edge convention: ``+inf`` thresholds (no
detection) within the halo of the signal's true ends.

Each builder returns ``fn(x_local)`` that every rank of the mesh calls on
its own shard; the output is that rank's shard.  The 1D builder splits the
last axis, the 2D builders the row axis (``-2``); leading axes are batch.
On a CUDA tensor :func:`os_cfar_1d_sharded` launches the k-th-smallest
kernel (``ops.cfar.os_1d``) and :func:`os_cfar_2d_detect_row_sharded` the
counting OS-CFAR detection kernel (``ops.cfar.os_2d_detect``);
:func:`ca_cfar_2d_row_sharded` is plain tensor code.
"""

from __future__ import annotations

import torch

from mmwave_radar_processing_tpu_torch.ops import cfar as cfar_ops
from mmwave_radar_processing_tpu_torch.parallel.collectives import (
    from_left, from_right, group_position,
)


def _exchange_halo_1d(x_local: torch.Tensor, halo: int, group, dim: int = 0):
    """Put both neighbours' edges around the shard: ``(extended, has_left, has_right)``.

    Edge ranks receive zeros on their open side; the caller masks the cells
    that saw them.  A shard shorter than the halo would return too few rows
    and a misaligned crop, so it raises.
    """
    if x_local.shape[dim] < halo:
        raise ValueError(
            f"sharded CFAR needs rows_per_shard >= num_train + num_guard "
            f"(= {halo}) on the sharded axis, got {x_local.shape[dim]}; use "
            f"fewer shards or a smaller train/guard window"
        )
    ranks, me = group_position(group)
    extended = torch.cat([from_left(x_local, halo, group, dim), x_local,
                          from_right(x_local, halo, group, dim)], dim)
    return extended, me > 0, me < len(ranks) - 1


def _edge_cells(m: int, halo: int, has_left: bool, has_right: bool, device) -> torch.Tensor:
    """bool ``[m]``: the cells within ``halo`` of a true end of the signal."""
    pos = torch.arange(m, device=device)
    return ((not has_left) & (pos < halo)) | ((not has_right) & (pos >= m - halo))


def os_cfar_1d_sharded(mesh, *, num_train: int, num_guard: int, rho: float, alpha: float,
                       axis: str = "data"):
    """Sharded OS-CFAR 1D thresholds over a signal whose last axis is split over ``axis``.

    Returns ``fn(x_local) -> thresholds``, float32 ``[..., L_local]``.
    """
    halo = num_train + num_guard
    group = mesh.get_group(axis)

    def local(x_local: torch.Tensor) -> torch.Tensor:
        extended, has_left, has_right = _exchange_halo_1d(x_local, halo, group, dim=-1)
        thr, _ = cfar_ops.os_1d(extended, num_train=num_train, num_guard=num_guard,
                                rho=rho, alpha=alpha)
        m = x_local.shape[-1]
        core = thr[..., halo:halo + m]
        bad = _edge_cells(m, halo, has_left, has_right, x_local.device)
        return torch.where(bad, torch.inf, core)

    return local


def ca_cfar_2d_row_sharded(mesh, *, num_train, num_guard, pfa: float, axis: str = "data"):
    """Sharded CA-CFAR 2D thresholds with the range (row) axis split over ``axis``.

    Rows near shard boundaries receive ``train + guard`` halo rows from the
    neighbouring shards; columns stay local.  Returns ``fn(x_local) ->
    thresholds``, float32 ``[..., R_local, D]``.
    """
    halo = num_train[0] + num_guard[0]
    group = mesh.get_group(axis)

    def local(x_local: torch.Tensor) -> torch.Tensor:
        extended, has_left, has_right = _exchange_halo_1d(x_local, halo, group, dim=-2)
        thr, _ = cfar_ops.ca_2d(extended, num_train=num_train, num_guard=num_guard, pfa=pfa)
        m = x_local.shape[-2]
        core = thr[..., halo:halo + m, :]
        bad = _edge_cells(m, halo, has_left, has_right, x_local.device)[:, None]
        return torch.where(bad, torch.inf, core)

    return local


def os_cfar_2d_detect_row_sharded(mesh, *, num_train, num_guard, rho: float, alpha: float,
                                  axis: str = "data"):
    """Sharded counting OS-CFAR 2D detection with the range (row) axis split over ``axis``.

    The multi-device counterpart of ``ops.cfar.os_2d_detect``: halo rows
    come from the neighbours, the local pass is the counting detection, and
    the mask is bit-equal to the unsharded one.  Returns ``fn(x_local) ->
    mask``, bool ``[..., R_local, D]``.
    """
    halo = num_train[0] + num_guard[0]
    group = mesh.get_group(axis)

    def local(x_local: torch.Tensor) -> torch.Tensor:
        extended, has_left, has_right = _exchange_halo_1d(x_local, halo, group, dim=-2)
        det = cfar_ops.os_2d_detect(extended, num_train=num_train, num_guard=num_guard,
                                    rho=rho, alpha=alpha)
        m = x_local.shape[-2]
        core = det[..., halo:halo + m, :]
        bad = _edge_cells(m, halo, has_left, has_right, x_local.device)[:, None]
        return core & ~bad

    return local
