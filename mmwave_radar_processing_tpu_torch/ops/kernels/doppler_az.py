"""Doppler-azimuth responses: the launch of the hand-written CUDA kernel and its count.

Replaces the TPU kernels ``set_responses_pallas_batch``,
``set_responses_pallas`` and ``group_responses_pallas_batch`` of the JAX
package's ``ops/pallas/doppler_az.py``: one function, three layouts, one
kernel here.  The source is ``csrc/doppler_az_responses.cu`` (one thread per
output, neighbouring threads on neighbouring velocity bins); it is compiled
by ``nvcc`` at first use (:mod:`._build`).  The plain PyTorch version and
the dispatch on the device live in :mod:`..doppler_az`.

``doppler_az_responses.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: entries of the channel table the kernel takes as an argument
MAX_TABLE = 64


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("doppler_az_responses").doppler_az_responses
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def doppler_az_responses(
    u_re: torch.Tensor, u_im: torch.Tensor, wgt: torch.Tensor,
    fct: torch.Tensor, fst: torch.Tensor, *, set_idx, nv: int,
) -> torch.Tensor:
    """Launch the kernel: CUDA float32 ``[B, C, W*nv]`` spectra -> ``[B, S, Av, nv]``.

    ``wgt`` is ``[B, W]``, ``fct``/``fst`` are ``[Av, S*n_rx]`` and
    ``set_idx`` is ``S`` tuples of ``n_rx`` channel indices.  Shapes are
    checked by the caller; this raises on anything else the kernel does not
    take, a tensor off the GPU or not contiguous included.
    """
    table = np.asarray(set_idx, np.int32)
    if table.size > MAX_TABLE:
        raise ValueError(f"{table.size} (set, antenna) pairs: the kernel takes "
                         f"at most {MAX_TABLE}")
    for t in (u_re, u_im, wgt, fct, fst):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 tensors, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"the response kernel needs CUDA tensors, got {t.device}")
        if t.device != u_re.device:
            raise ValueError(f"tensors on {t.device} and {u_re.device}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    b, n_ch, m = u_re.shape
    n_sets, n_rx = table.shape
    n_angles = fct.shape[0]
    out = torch.empty((b, n_sets, n_angles, nv), dtype=torch.float32,
                      device=u_re.device)
    if b == 0:
        return out
    table = np.ascontiguousarray(table.reshape(-1))
    launch = _kernel()
    with torch.cuda.device(u_re.device):
        stream = torch.cuda.current_stream(u_re.device).cuda_stream
        err = launch(u_re.data_ptr(), u_im.data_ptr(), wgt.data_ptr(),
                     fct.data_ptr(), fst.data_ptr(),
                     table.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                     out.data_ptr(), b, n_ch, m // nv, nv, n_sets, n_rx,
                     n_angles, stream)
    if err != 0:
        raise RuntimeError(f"doppler_az_responses kernel launch failed: CUDA error {err}")
    doppler_az_responses.launches += 1
    return out


doppler_az_responses.launches = 0
