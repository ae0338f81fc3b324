"""The DBS velocity-steered pick: the launch of the hand-written CUDA kernel and its count.

Replaces no TPU kernel: the JAX package forms the whole angle DFT of the
range-Doppler cube and gathers from it in plain XLA
(``parallel/spectral_pipeline.py``).  The kernel source is
``csrc/dbs_pick.cu``: a block a frame and a tile of range rows, the frame's
bins, the weights and the tile's spectrum staged in shared memory, one
thread an output; only the kept magnitudes are written.  It is compiled by
``nvcc`` at first use (:mod:`._build`).  The plain PyTorch version and the
dispatch on the device live in :mod:`..dft`.

``dbs_pick.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: the most antennas a block stages (``kMaxAntennas`` in the source)
MAX_ANTENNAS = 16
#: a block's dynamic shared memory on Hopper (``kMaxSharedBytes``)
MAX_SHARED_BYTES = 227 * 1024


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("dbs_pick").dbs_pick
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_bytes(antennas: int, loops: int, dbs_bins: int) -> int:
    """A block's shared memory at one range row a tile, as the source stages it: the least it takes."""
    return 8 * (antennas * (loops + loops % 2) + antennas * dbs_bins) + 4 * dbs_bins


def dbs_pick(spec: torch.Tensor, weights: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``[B, A, ns, L]``, ``[A, D]`` complex64 and ``[B, D]`` int64 -> ``[B, ns, D]`` float32.

    ``out[b, r, d] = cabs(sum_a spec[b, a, r, bins[b, d]] * weights[a, d])``
    in float32, the sum in antenna order (``ops.dft.dbs_pick_reference`` is
    the plain version).  A bin outside ``[0, L)`` gives NaN.  Raises on
    anything the kernel does not take: another dtype, a tensor off the GPU or
    not contiguous, the three on different devices, shapes that do not
    match, ``A`` outside ``1..MAX_ANTENNAS``, no Doppler bins, or weights too
    wide for a block's shared memory.
    """
    for name, t, dtype in (("spec", spec, torch.complex64), ("weights", weights, torch.complex64),
                           ("bins", bins, torch.int64)):
        if t.dtype != dtype:
            raise TypeError(f"the DBS pick kernel takes {dtype} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the DBS pick kernel needs a contiguous {name} tensor")
    if spec.dim() != 4 or weights.dim() != 2 or bins.dim() != 2:
        raise ValueError(f"expected spec [B, A, ns, L], weights [A, D] and bins [B, D], got "
                         f"{tuple(spec.shape)}, {tuple(weights.shape)} and {tuple(bins.shape)}")
    b, a, ns, loops = spec.shape
    d = weights.shape[1]
    if weights.shape[0] != a or bins.shape != (b, d):
        raise ValueError(f"expected weights [{a}, D] and bins [{b}, D], got "
                         f"{tuple(weights.shape)} and {tuple(bins.shape)}")
    if not 1 <= a <= MAX_ANTENNAS:
        raise ValueError(f"the DBS pick kernel stages 1 to {MAX_ANTENNAS} antennas, got {a}")
    if loops < 1:
        raise ValueError(f"the DBS pick kernel needs Doppler bins to pick from, got L = {loops}")
    if shared_bytes(a, loops, d) > MAX_SHARED_BYTES:
        raise ValueError(f"A = {a}, L = {loops}, D = {d}: one range row does not fit a block's "
                         f"shared memory ({shared_bytes(a, loops, d)} > {MAX_SHARED_BYTES} bytes)")
    if spec.device.type != "cuda":
        raise ValueError(f"the DBS pick kernel needs a CUDA tensor, got {spec.device}")
    if weights.device != spec.device or bins.device != spec.device:
        raise ValueError(f"spec on {spec.device}, weights on {weights.device}, "
                         f"bins on {bins.device}")
    out = torch.empty((b, ns, d), dtype=torch.float32, device=spec.device)
    if out.numel() == 0:
        return out
    launch = _kernel()
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        err = launch(spec.data_ptr(), weights.data_ptr(), bins.data_ptr(), b, a, ns, loops, d,
                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dbs_pick kernel launch failed at {b} frames, A={a}, ns={ns}, "
                           f"L={loops}, D={d}: CUDA error {err}")
    dbs_pick.launches += 1
    return out


dbs_pick.launches = 0
