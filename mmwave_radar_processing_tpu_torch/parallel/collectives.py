"""The collectives of the multi-device layer on one mesh axis's process group.

- :func:`from_left` and :func:`from_right` are the JAX package's neighbour
  shifts, ``ppermute`` over ``[(i, i + 1)]`` and ``[(i + 1, i)]``
  (``parallel/halo_cfar.py:48-56``): each rank sends an edge of its shard to
  one neighbour and receives the other neighbour's.  An edge rank, which
  has no neighbour on that side, receives zeros, as ``ppermute`` gives.
  They post their sends and receives together (``dist.batch_isend_irecv``).
- :func:`psum` is an all-reduce by sum (``dist.all_reduce``) into a copy.

The staging rule: gloo sends and receives host tensors only.  When the
group's backend is gloo and the tensor is on a GPU, the edges go through
pinned host buffers, and what arrives is copied back to the GPU.  The
backend decides this, and it is never the answer to a caught error.  The
computation stays on the GPU.  NCCL takes the GPU tensors as they are, and
so does gloo's all-reduce.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def staged(group, t: torch.Tensor) -> bool:
    """Whether a point-to-point message of ``t`` on ``group`` goes through host memory (gloo and CUDA)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def group_position(group):
    """``(global ranks of the group, this rank's index in it)``."""
    ranks = dist.get_process_group_ranks(group)
    return ranks, dist.get_group_rank(group, dist.get_rank())


def _shift(edge: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``edge`` to the neighbour ``step`` places on; return what the one ``step`` places back sent."""
    ranks, me = group_position(group)
    dst, src = me + step, me - step
    has_dst, has_src = 0 <= dst < len(ranks), 0 <= src < len(ranks)
    out = torch.zeros(edge.shape, dtype=edge.dtype, device=edge.device)
    if edge.numel() == 0 or not (has_dst or has_src):
        return out
    send, recv = edge.contiguous(), out
    if staged(group, edge):
        send = torch.empty(edge.shape, dtype=edge.dtype, pin_memory=True).copy_(edge)
        recv = torch.empty(edge.shape, dtype=edge.dtype, pin_memory=True)
    ops = []
    if has_dst:
        ops.append(dist.P2POp(dist.isend, send, ranks[dst], group))
    if has_src:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[src], group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if has_src and recv is not out:
        out.copy_(recv)
    return out


def from_left(x: torch.Tensor, halo: int, group, dim: int = 0) -> torch.Tensor:
    """The left neighbour's last ``halo`` slices of ``x`` along ``dim``; zeros on the first rank."""
    return _shift(x.narrow(dim, x.shape[dim] - halo, halo), group, +1)


def from_right(x: torch.Tensor, halo: int, group, dim: int = 0) -> torch.Tensor:
    """The right neighbour's first ``halo`` slices of ``x`` along ``dim``; zeros on the last rank."""
    return _shift(x.narrow(dim, 0, halo), group, -1)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (JAX: ``jax.lax.psum``), in a new tensor."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
