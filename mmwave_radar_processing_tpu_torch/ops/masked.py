"""Fixed-capacity compaction of detection masks (JAX: ``ops/masked.py``).

A variable number of detections becomes a padded index array, a validity
mask and a count, so every shape stays static and nothing syncs with the
host (``torch.nonzero`` would).  Compaction is a ``topk`` of the smallest
index keys: a True entry's key is its own index, a False entry's key is
``n``, so the ``capacity`` smallest keys in ascending order are exactly the
first ``capacity`` True positions.  The keys are distinct integers, so the
selection is exact.
"""

from __future__ import annotations

import torch


def mask_to_indices(mask: torch.Tensor, capacity: int):
    """Ascending indices of the True entries along the last axis.

    ``mask``: ``bool [..., n]``.  Returns ``(indices, valid, count)``:

    - ``indices``: ``int64 [..., capacity]``; the first ``count`` entries are
      the True positions in ascending order, the rest are 0.
    - ``valid``: ``bool [..., capacity]``.
    - ``count``: ``int32 [...]`` number of True entries, clamped to
      ``capacity``.
    """
    n = mask.shape[-1]
    k = min(capacity, n)
    keys = torch.where(mask, torch.arange(n, device=mask.device), n)
    order = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    if k < capacity:  # capacity may exceed the mask length
        order = torch.nn.functional.pad(order, (0, capacity - k), value=n)
    valid = order < n
    indices = torch.where(valid, order, 0)
    count = torch.clamp(mask.sum(dim=-1), max=capacity).to(torch.int32)
    return indices, valid, count


def mask_to_indices_2d(mask: torch.Tensor, capacity: int, *, interior=None):
    """Row-major ``(row, col)`` indices of the True entries of ``bool [..., r, c]``.

    Returns ``(rows, cols, valid, count)`` with the padding of
    :func:`mask_to_indices`.  Row-major order matches ``np.where``.

    ``interior``: optional ``(edge_rows, edge_cols)``.  The caller guarantees
    that every True entry lies inside ``mask[..., er:-er, ed:-ed]`` (a CFAR
    map is False on its edges by construction); only that slab is compacted
    and the indices are mapped back to full-map coordinates.  Results are
    identical, because interior row-major order is full-map row-major order
    restricted to the interior.
    """
    r, c = mask.shape[-2:]
    if interior is not None and any(interior):
        er, ed = interior
        inner = mask[..., er : r - er, ed : c - ed]
        ri, ci, valid, count = mask_to_indices_2d(inner, capacity)
        return (torch.where(valid, ri + er, 0), torch.where(valid, ci + ed, 0),
                valid, count)
    flat_idx, valid, count = mask_to_indices(mask.flatten(-2), capacity)
    return flat_idx // c, flat_idx % c, valid, count
