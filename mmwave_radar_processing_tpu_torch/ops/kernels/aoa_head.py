"""The angle head: the launch of the hand-written CUDA kernel and its count.

Replaces no TPU kernel: the JAX package computes the detections' values and
angles in plain XLA (``ops/mxu.py``: ``rd_values_from_range_dft``,
``aoa_peak_angles``).  The kernel source is ``csrc/aoa_head.cu``: a block a
frame's 256 slots lists its filled ones by range row; a warp reads each row
of the channels the angles use once and forms the Doppler value of every
slot on it; four threads a subset take the angle DFT's bins and their first
peak; a thread a slot writes the point.  An empty slot costs its flag and its
zeros.  It is compiled by ``nvcc`` at first use (:mod:`._build`).  The plain
PyTorch version and the dispatch on the device live in
``parallel/point_stages.AngleHead``.

``aoa_head.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: distinct channels of ``R`` the angles may read (``kMaxChannels`` in the source)
MAX_CHANNELS = 16
#: positions a subset may hold (``kMaxAntennas``)
MAX_ANTENNAS = 16
#: a block's dynamic shared memory (``kMaxDynamicBytes``): the rows' counts and the angle DFTs
MAX_DYNAMIC_BYTES = 64 * 1024


def dynamic_bytes(rows: int, n_az: int, n_el: int, bins: int) -> int:
    """A block's dynamic shared memory, as the source lays it out: an int a row, then both DFTs."""
    return (4 * rows + 7) // 8 * 8 + 8 * (n_az + n_el) * bins


class ChannelLayout(NamedTuple):
    channels: Tuple[int, ...]  # the channels of R read, ascending
    az: Tuple[int, ...]  # the azimuth subset as indices into ``channels``
    el: Tuple[int, ...]  # the elevation subset likewise


@functools.lru_cache(maxsize=64)
def channel_layout(az_pos: Tuple[int, ...], el_pos: Tuple[int, ...]) -> ChannelLayout:
    """The channels of ``R`` that two position sets read, and each set's entries in them."""
    channels = tuple(sorted(set(az_pos) | set(el_pos)))
    return ChannelLayout(channels, tuple(channels.index(p) for p in az_pos),
                         tuple(channels.index(p) for p in el_pos))


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("aoa_head").aoa_head
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr, i64, i32, i32, i32,  # R, its batch stride, channels, rows, loops
                   ptr, i64, i64, i32,  # dop, its strides, Doppler bins
                   ptr, ptr, ptr, i64, i32,  # r_idx, v_idx, valid, frames, slots
                   ptr, i32, ptr, i32, ptr, i32,  # the layout's host arrays
                   ptr, ptr, ptr, i32,  # az_dft, el_dft, angle_bins, bins
                   f32, f32, f32, ptr, ptr]  # range_res, vel0, vel_res, out, stream
    fn.restype = ctypes.c_int
    return fn


def _ints(values: Sequence[int]):
    return (ctypes.c_int * max(len(values), 1))(*values)


def _check(name, t, dtype, device, shape=None, contiguous=True):
    if t.dtype != dtype:
        raise TypeError(f"the angle head kernel takes {dtype} {name}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"R on {device}, {name} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected {name} of shape {list(shape)}, got {list(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"the angle head kernel needs a contiguous {name} tensor")


def aoa_head(R: torch.Tensor, dop: torch.Tensor, r_idx: torch.Tensor, v_idx: torch.Tensor,
             valid: torch.Tensor, *, az_pos: Sequence[int], el_pos: Sequence[int],
             az_dft: torch.Tensor, el_dft: torch.Tensor, angle_bins: torch.Tensor,
             range_res: float, vel0: float, vel_res: float) -> torch.Tensor:
    """Launch the kernel: the FLU points ``float32 [B, K, 4]`` of the filled slots, 0 elsewhere.

    ``R`` complex64 ``[B, C, W, L]`` with its inner three dims contiguous
    (any batch stride, so a view of a wider cube is read in place), ``dop``
    complex64 ``[L, V]`` (any strides), ``r_idx``, ``v_idx`` int64 and
    ``valid`` bool ``[B, K]``; ``az_pos``/``el_pos`` host positions on
    ``R``'s channel axis (either may be empty: angle 0), ``az_dft``/``el_dft``
    complex64 ``[max(n, 1), M]`` and ``angle_bins`` float32 ``[M]``; the
    grid's range resolution, first velocity and velocity step.  The plain
    version is ``AngleHead.plain``; only the order of the Doppler sum differs
    (``csrc/aoa_head.cu``).  A filled slot whose bins lie off ``R`` or
    ``dop`` gives NaN.  Raises on anything the kernel does not take: another
    dtype, a tensor off the GPU, on another device or laid out otherwise,
    shapes that do not match, positions off ``R``, more than
    ``MAX_ANTENNAS`` in a subset or ``MAX_CHANNELS`` in their union, no
    angle bins, or range rows and angle DFTs over ``MAX_DYNAMIC_BYTES``.
    """
    if R.dtype != torch.complex64:
        raise TypeError(f"the angle head kernel takes complex64 R, got {R.dtype}")
    if R.dim() != 4:
        raise ValueError(f"expected R [B, C, W, L], got {list(R.shape)}")
    b, c, w, loops = R.shape
    if (c > 1 and R.stride(1) != w * loops) or (w > 1 and R.stride(2) != loops) \
            or (loops > 1 and R.stride(3) != 1):
        raise ValueError(f"the angle head kernel needs R's inner three dims contiguous, got "
                         f"strides {R.stride()} of shape {list(R.shape)}")
    device = R.device
    if dop.dim() != 2 or dop.shape[0] != loops:
        raise ValueError(f"expected dop [{loops}, V], got {list(dop.shape)}")
    _check("dop", dop, torch.complex64, device, contiguous=False)
    if r_idx.dim() != 2 or r_idx.shape[0] != b:
        raise ValueError(f"expected r_idx [{b}, K], got {list(r_idx.shape)}")
    k = r_idx.shape[1]
    _check("r_idx", r_idx, torch.int64, device)
    _check("v_idx", v_idx, torch.int64, device, (b, k))
    _check("valid", valid, torch.bool, device, (b, k))
    az_pos, el_pos = tuple(int(p) for p in az_pos), tuple(int(p) for p in el_pos)
    for name, pos in (("az", az_pos), ("el", el_pos)):
        if len(pos) > MAX_ANTENNAS:
            raise ValueError(f"the angle head kernel takes up to {MAX_ANTENNAS} {name} "
                             f"positions, got {len(pos)}")
        if any(not 0 <= p < c for p in pos):
            raise ValueError(f"{name} positions {list(pos)} lie off R's {c} channels")
    layout = channel_layout(az_pos, el_pos)
    if len(layout.channels) > MAX_CHANNELS:
        raise ValueError(f"the angle head kernel reads up to {MAX_CHANNELS} channels, the "
                         f"positions name {len(layout.channels)}")
    if angle_bins.dim() != 1 or angle_bins.shape[0] < 1:
        raise ValueError(f"expected angle_bins [M] with M >= 1, got {list(angle_bins.shape)}")
    m = angle_bins.shape[0]
    _check("angle_bins", angle_bins, torch.float32, device)
    _check("az_dft", az_dft, torch.complex64, device, (max(len(az_pos), 1), m))
    _check("el_dft", el_dft, torch.complex64, device, (max(len(el_pos), 1), m))
    smem = dynamic_bytes(w, len(az_pos), len(el_pos), m)
    if smem > MAX_DYNAMIC_BYTES:
        raise ValueError(f"{w} range rows and {len(az_pos) + len(el_pos)} x {m} angle DFT values "
                         f"take {smem} bytes of a block's shared memory, over {MAX_DYNAMIC_BYTES}")
    if device.type != "cuda":
        raise ValueError(f"the angle head kernel needs a CUDA tensor, got {device}")
    out = torch.empty((b, k, 4), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    launch = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(R.data_ptr(), R.stride(0), c, w, loops,
                     dop.data_ptr(), dop.stride(0), dop.stride(1), dop.shape[1],
                     r_idx.data_ptr(), v_idx.data_ptr(), valid.data_ptr(), b, k,
                     _ints(layout.channels), len(layout.channels), _ints(layout.az),
                     len(layout.az), _ints(layout.el), len(layout.el),
                     az_dft.data_ptr(), el_dft.data_ptr(), angle_bins.data_ptr(), m,
                     range_res, vel0, vel_res, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"aoa_head kernel launch failed at {b} frames, {k} slots, R "
                           f"{list(R.shape)}, {len(layout.channels)} channels, M={m}: "
                           f"CUDA error {err}")
    aoa_head.launches += 1
    return out


aoa_head.launches = 0
