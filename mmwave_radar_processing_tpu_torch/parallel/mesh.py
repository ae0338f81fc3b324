"""Device-mesh helpers over ``torch.distributed`` (JAX: ``parallel/mesh.py``).

Each rank is one process (:mod:`.launch`), so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of ranks with named axes, and
each rank holds plain local tensors: its own shard, as the body of JAX's
``shard_map`` sees it.  There is no global array, so JAX's
``data_sharding`` has no counterpart; :func:`frame_slice` says which frames
of a global batch a rank's coordinate owns.  Collectives run on the group
of one mesh axis (``mesh.get_group(axis)``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axes: Dict[str, int], *, device_type: str) -> DeviceMesh:
    """Build a named mesh of the process group's ranks, e.g. ``make_mesh({"data": 2, "model": 2})``.

    Axis sizes must multiply to the world size; pass ``-1`` for one axis to
    infer it.  Every rank calls it, in the same order (it creates the axes'
    process groups).  ``device_type`` is where the ranks compute: ``"cuda"``
    or ``"cpu"``.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(start the ranks with parallel.launch.spawn)")
    world = dist.get_world_size()
    sizes = dict(axes)
    unknown = [k for k, v in sizes.items() if v == -1]
    known = int(np.prod([v for v in sizes.values() if v != -1]))
    if unknown:
        if len(unknown) > 1:
            raise ValueError("at most one axis may be -1")
        sizes[unknown[0]] = world // known
    total = int(np.prod(list(sizes.values())))
    if total != world:
        raise ValueError(f"mesh {sizes} does not match {world} devices")
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes.keys()))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Number of ranks along ``axis`` (JAX: ``jax.lax.axis_size``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (JAX: ``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def frame_slice(mesh: DeviceMesh, n_global: int, axis: str = "data") -> slice:
    """The slice of a global batch's leading axis that this rank's coordinate on ``axis`` owns.

    Each coordinate owns ``n_global // axis_size`` consecutive frames.
    Ownership is along ``axis`` only: on a ``(data, model)`` mesh every rank
    of data-row ``i`` owns frame shard ``i``, so ranks that share a row hold
    the same frames.  Raises when ``n_global`` does not divide over the axis.
    """
    n = axis_size(mesh, axis)
    if n_global % n:
        raise ValueError(f"global batch {n_global} not divisible by {n}")
    per = n_global // n
    i = axis_index(mesh, axis)
    return slice(i * per, (i + 1) * per)
