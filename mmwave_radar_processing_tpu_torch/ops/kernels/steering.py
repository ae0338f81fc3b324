"""The synthetic-aperture steering phases: the launch of the hand-written CUDA kernel and its count.

Replaces no TPU kernel: the JAX package computes the phases as plain
``jnp`` (``processors/synthetic_array.py``, ``parallel/beamform_pipeline.py``).
The kernel source is ``csrc/steering_phases.cu``: a block a frame and a tile
of 32 directions, the frame's positions staged in shared memory, a warp a
direction writing its row of phases along the elements in 16-byte stores;
the angles never leave registers.  It is compiled by ``nvcc`` at first use
(:mod:`._build`).  The plain PyTorch version and the dispatch on the device
live in :mod:`...processors.synthetic_array`.

``steering_phases.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("steering_phases").steering_phases
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def angle_factors(lambda_m: float) -> tuple[np.float32, np.float32]:
    """The two float32 factors of the angle: ``2*pi``, then the reciprocal of ``lambda``.

    As the plain version rounds them on CUDA: PyTorch multiplies by a
    Python scalar cast to float32, and divides by one as a multiply by the
    float32 reciprocal of the scalar cast to float32.
    """
    return np.float32(2 * np.pi), np.float32(1) / np.float32(lambda_m)


def steering_phases(steering: torch.Tensor, positions: torch.Tensor,
                    lambda_m: float) -> torch.Tensor:
    """Launch the kernel: CUDA float32 ``(A, 3) x [..., 3, E] -> [..., A, E]`` complex64.

    ``exp(j*2*pi*(steering @ positions)/lambda)`` in the plain version's
    float32 order (``processors.synthetic_array.steering_phases_reference``).
    Raises on anything the kernel does not take: another dtype, a tensor
    off the GPU or not contiguous, the two on different devices, shapes
    other than ``(A, 3)`` and ``[..., 3, E]``.
    """
    for name, t in (("steering", steering), ("positions", positions)):
        if t.dtype != torch.float32:
            raise TypeError(f"the steering-phase kernel takes float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the steering-phase kernel needs a contiguous {name} tensor")
    if steering.dim() != 2 or steering.shape[1] != 3:
        raise ValueError(f"steering: expected shape (A, 3), got {tuple(steering.shape)}")
    if positions.dim() < 2 or positions.shape[-2] != 3:
        raise ValueError(f"positions: expected shape [..., 3, E], got {tuple(positions.shape)}")
    if positions.device.type != "cuda":
        raise ValueError(f"the steering-phase kernel needs a CUDA tensor, got {positions.device}")
    if steering.device != positions.device:
        raise ValueError(f"steering on {steering.device}, positions on {positions.device}")
    a_len, e_len = steering.shape[0], positions.shape[-1]
    batch = positions.shape[:-2]
    out = torch.empty((*batch, a_len, e_len), dtype=torch.complex64, device=positions.device)
    if out.numel() == 0:
        return out
    frames = positions.numel() // (3 * e_len)
    two_pi, inv_lambda = angle_factors(lambda_m)
    launch = _kernel()
    with torch.cuda.device(positions.device):
        stream = torch.cuda.current_stream(positions.device).cuda_stream
        err = launch(steering.data_ptr(), positions.data_ptr(), frames, a_len, e_len,
                     two_pi, inv_lambda, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"steering_phases kernel launch failed at {frames} frames, "
                           f"A={a_len}, E={e_len}: CUDA error {err}")
    steering_phases.launches += 1
    return out


steering_phases.launches = 0
