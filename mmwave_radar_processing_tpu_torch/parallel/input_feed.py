"""The per-rank input feed of the frame-parallel pipelines (JAX: ``parallel/input_feed.py``).

On a multi-host mesh each process must load only the frames its devices
own.  The JAX package loads a process's share and stitches the global
array with ``jax.make_array_from_process_local_data``.  The port runs one
process a rank and keeps no global array: each rank loads its own frames
through the NPY bulk loader (:class:`..data.native_loader.SplitFramePrefetcher`,
double-buffered on a host thread) and hands its local batch to its
pipeline.  So ``global_batch_from_local`` has no counterpart.

The prefetcher yields views of two reused host slots.  On a GPU the feed
copies each batch to the device from pinned memory without blocking and
hands the prefetcher an event recorded behind the copy (``release``), so
the slot is refilled only once the copy has finished.  On the CPU it yields
a copy of the slot.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from mmwave_radar_processing_tpu_torch.data.native_loader import SplitFramePrefetcher
from mmwave_radar_processing_tpu_torch.parallel.mesh import frame_slice


#: the frames of a global batch that this rank loads, under JAX's name:
#: ownership is along the sharding axis only (:func:`.mesh.frame_slice`)
process_local_frame_slice = frame_slice


def sharded_recording_feed(
    mesh,
    paths: Sequence[str],
    frame_shape: Tuple[int, ...],
    *,
    global_batch: int,
    axis: str = "data",
    altitude: float = 1.2,
    nthreads: int = 8,
    device,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Stream this rank's ``(raw_re, raw_im, altitude)`` of each global batch of NPY frames.

    ``paths`` hold complex frames of ``frame_shape``, ``global_batch`` of
    them a batch (a short tail is dropped, as in the JAX package).  Yields
    float32 ``[b, *frame_shape]`` planes and a float32 ``[b]`` altitude on
    ``device``, ``b`` this rank's share of the batch.
    """
    device = torch.device(device)
    n_batches = len(paths) // global_batch
    local = process_local_frame_slice(mesh, global_batch, axis)
    local_paths: List[str] = []
    for b in range(n_batches):
        local_paths.extend(list(paths[b * global_batch:(b + 1) * global_batch])[local])
    per_batch = local.stop - local.start
    if not local_paths:
        return
    cuda = device.type == "cuda"
    prefetcher = SplitFramePrefetcher(local_paths, frame_shape, batch=per_batch,
                                      nthreads=nthreads, pin_memory=cuda)
    for re, im in prefetcher:
        if cuda:
            re_d = re.to(device, non_blocking=True)
            im_d = im.to(device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            prefetcher.release(copied)
        else:
            re_d, im_d = re.clone(), im.clone()
        yield re_d, im_d, torch.full((per_batch,), altitude, dtype=torch.float32, device=device)
