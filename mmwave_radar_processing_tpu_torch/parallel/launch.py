"""Start SPMD ranks, one process a rank, and collect what each returns.

The JAX package's multi-device layer is single-controller: one process holds
every device, and ``shard_map`` runs the per-shard body on each of them.
The port follows PyTorch's idiom instead: one process a rank, a process
group, and explicit collectives.  :func:`spawn` stands in for the
single-controller mesh.  It starts ``world_size`` processes with the
``spawn`` start method.  They meet through a ``FileStore`` in a temporary
directory (no TCP port, no network) and join one process group.  Each calls
``fn(device, *args)`` and sends the result back.

Backends, chosen by the caller and never by a caught error:

- ``"nccl"``: one rank a GPU, rank ``r`` on ``cuda:r``; NCCL refuses two
  ranks on one device, so ``world_size`` may not exceed the GPU count.
- ``"gloo"``: any number of ranks.  With ``device="cuda"`` rank ``r``
  computes on ``cuda:(r % device_count)``, so on a host with one GPU every
  rank shares it.  gloo moves point-to-point messages between host tensors
  only; :mod:`.collectives` stages them through pinned host buffers.  Its
  all-reduce takes CUDA tensors as they are.

:func:`default_backend` states the rule the port's harnesses use: NCCL
where every rank has a GPU of its own, gloo otherwise.  Ranks that share one
GPU measure its oversubscription, not a link between devices.

``fn`` must be a module-level function of an importable module (it is sent
to the ranks by name), and so must everything in ``args``.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_module
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")

#: seconds a rank that has exited may take to deliver its report
_REPORT_GRACE_S = 5.0
#: seconds the ranks get to exit once every result is in
_EXIT_GRACE_S = 30.0


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device rank ``rank`` computes on: ``cuda:(rank % device_count)`` or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def default_backend(world_size: int, device) -> str:
    """``"nccl"`` when ``device`` is CUDA and every rank has a GPU of its own, else ``"gloo"``."""
    device_type = torch.device(device).type
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _check(world_size: int, backend: str, device_type: str) -> None:
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False)")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if world_size > torch.cuda.device_count():
            raise ValueError(f"nccl takes one rank a GPU: {world_size} ranks, "
                             f"{torch.cuda.device_count()} GPUs; use gloo")


def _rank_main(rank, world_size, backend, device_type, store_path, timeout_s,
               threads, fn, args, results):
    """One rank: join the group, run ``fn(device, *args)``, report the result or the traceback."""
    try:
        device = rank_device(rank, device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(device, *args)
        finally:
            dist.destroy_process_group()
    except Exception:  # the rank's boundary: the parent re-raises it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def spawn(fn: Callable, world_size: int, *, backend: str, device, args: Sequence[Any] = (),
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(device, *args)`` on ``world_size`` ranks; returns their results by rank.

    If a rank raises, the other ranks are killed and a ``RuntimeError``
    carrying that rank's traceback is raised here; a rank that dies without
    a report raises too.  ``timeout`` (seconds) bounds the whole run and
    each collective: past it the ranks are killed and ``TimeoutError`` is
    raised.  On the CPU each rank gets an equal share of the host's cores.
    """
    device_type = torch.device(device).type
    _check(world_size, backend, device_type)
    threads = max(1, (os.cpu_count() or 1) // world_size)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mrp_ranks_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, name=f"rank{rank}",
                             args=(rank, world_size, backend, device_type, store_path,
                                   timeout, threads, fn, tuple(args), results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        done = {}
        failed = True
        try:
            deadline = time.monotonic() + timeout
            dead_since = {}
            while len(done) < world_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = [r for r in range(world_size) if r not in done]
                    raise TimeoutError(f"ranks {missing} of {world_size} did not finish "
                                       f"within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(remaining, 0.5))
                except queue_module.Empty:
                    now = time.monotonic()
                    for r, p in enumerate(procs):
                        if r in done or p.exitcode is None:
                            continue
                        if now - dead_since.setdefault(r, now) > _REPORT_GRACE_S:
                            raise RuntimeError(f"rank {r} of {world_size} exited with code "
                                               f"{p.exitcode} and reported nothing")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
                done[rank] = payload
            failed = False
        finally:
            for p in procs:
                p.join(timeout=0 if failed else _EXIT_GRACE_S)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [done[r] for r in range(world_size)]
