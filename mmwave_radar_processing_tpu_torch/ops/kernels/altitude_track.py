"""The altimeter recursion of the ground scan: the launch of the hand-written CUDA kernel and its count.

Replaces the ``lax.scan`` of ``parallel/ground_pipeline.py`` in the JAX
package (no Pallas kernel: XLA's scan).  The kernel source is
``csrc/altitude_track.cu``: one block; the other threads stage the frames'
candidates in shared memory, two chunks in turn, while one thread walks the
recording.  It is compiled by ``nvcc`` at first use (:mod:`._build`).  The
plain PyTorch version and the dispatch on the device live in
:mod:`..altitude`.

``altitude_track.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: coarse candidates a frame and refinements a candidate, as the kernel is built
CANDIDATES, REFINEMENTS = 3, 2


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("altitude_track").altitude_track
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def altitude_track(
    cand: torch.Tensor, valid: torch.Tensor, zbins: Optional[torch.Tensor],
    zvalid: Optional[torch.Tensor], init: torch.Tensor, *, min_altitude_m: float,
    altitude_search_limit_m: float, range_bias: float, precise: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: CUDA ``cand, valid [T, 3]``, ``zbins, zvalid [T, 3, 2]``, ``init []``.

    Returns ``(alts float32 [T], final float32 [])``, equal bit for bit to
    ``ops.altitude.altitude_track_reference``.  ``zbins`` and ``zvalid`` are
    needed only when ``precise``.  Raises on anything the kernel does not
    take, such as a tensor off the GPU.
    """
    if cand.device.type != "cuda":
        raise ValueError(f"the altitude-recursion kernel needs a CUDA tensor, got "
                         f"{cand.device}")
    frames = cand.shape[0] if cand.dim() == 2 else -1
    _check("cand", cand, torch.float32, (frames, CANDIDATES), cand.device)
    _check("valid", valid, torch.bool, (frames, CANDIDATES), cand.device)
    _check("init", init, torch.float32, (), cand.device)
    if precise:
        if zbins is None or zvalid is None:
            raise ValueError("precise: the refinements zbins and zvalid are needed")
        zshape = (frames, CANDIDATES, REFINEMENTS)
        _check("zbins", zbins, torch.float32, zshape, cand.device)
        _check("zvalid", zvalid, torch.bool, zshape, cand.device)
    alts = torch.empty((frames,), dtype=torch.float32, device=cand.device)
    if frames == 0:
        return alts, init.clone()
    final = torch.empty((), dtype=torch.float32, device=cand.device)
    launch = _kernel()
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream(cand.device).cuda_stream
        err = launch(cand.data_ptr(), valid.data_ptr(),
                     zbins.data_ptr() if precise else None,
                     zvalid.data_ptr() if precise else None,
                     init.data_ptr(), alts.data_ptr(), final.data_ptr(), frames,
                     np.float32(min_altitude_m), np.float32(altitude_search_limit_m),
                     np.float32(range_bias), int(bool(precise)), stream)
    if err != 0:
        raise RuntimeError(f"altitude_track kernel launch failed at T={frames}: "
                           f"CUDA error {err}")
    altitude_track.launches += 1
    return alts, final


altitude_track.launches = 0
