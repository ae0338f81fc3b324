"""OS-CFAR 2D: the launches of the two hand-written CUDA kernels and their counts.

:func:`os_cfar_2d_detect` and :func:`os_cfar_2d_detect_compact` replace the TPU
kernel ``ops/pallas/os_cfar.py::os_cfar_2d_detect_fused`` of the JAX package
(source ``csrc/os_cfar_detect.cu``: a block scales a tile's region once into
shared memory, a thread counts for a strip of 4 cells; the compacting entry
also writes the first detections' indices, one block a frame;
:func:`detect_launch_geometry` cuts a map into tiles), and
:func:`os_cfar_2d_noise` replaces
``ops/pallas/os_cfar.py::os_cfar_2d_noise_fused`` (source
``csrc/os_rank_select.cu``: a block sorts a tile's region, replaces every
value by its rank and searches each window's k-th smallest rank;
:func:`noise_launch_geometry` cuts a map into tiles).  Both sources are compiled by
``nvcc`` at first use (:mod:`._build`).  The window geometry, the rank ``k``,
the plain PyTorch versions and the dispatch on the device live in
:mod:`..cfar`.

``os_cfar_2d_detect.launches`` and ``os_cfar_2d_noise.launches`` count kernel
launches; a launch of the compacting entry counts as one of
``os_cfar_2d_detect``, whose kernel it is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

_THREADS = 256  # kThreads of both sources
#: cells a thread takes: a strip of 4 neighbours in a row
STRIP = 4
#: blocks wanted in flight (one for each of an H100's 132 SMs), and the tile
#: below which a small batch is not cut further
_TARGET_BLOCKS = 132
_MIN_TILE_CELLS = 64
#: a block's dynamic shared memory on Hopper
MAX_SHARED_BYTES = 227 * 1024
#: the detection kernel's tiles are cut until one needs at most this much
#: shared memory: four blocks then fit an SM
PREFERRED_DETECT_SHARED_BYTES = 56 * 1024


def _check_maps(x: torch.Tensor) -> None:
    """Raise on anything the kernels do not take, a tensor off the GPU included."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 maps, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"expected [B, R, D] maps, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"the OS-CFAR kernel needs a CUDA tensor, got {x.device}")


def _cut_tiles(r_out: int, d_out: int, batch: int, too_big):
    """``(tile_r, tile_d)``: the core cut into tiles, the longer side first.

    Cut until ``too_big(tile_r, tile_d)`` is False and, for a small batch,
    until ``batch * tiles`` reaches ``_TARGET_BLOCKS`` or a tile is down to
    ``_MIN_TILE_CELLS`` cells.  ``tile_d`` is a multiple of ``STRIP``.
    """
    tiles_r = tiles_d = 1
    while True:
        tile_r = -(-r_out // tiles_r)
        tile_d = STRIP * -(-(-(-d_out // tiles_d)) // STRIP)
        n_tiles = -(-r_out // tile_r) * -(-d_out // tile_d)
        too_few = (max(batch, 1) * n_tiles < _TARGET_BLOCKS
                   and tile_r * tile_d > _MIN_TILE_CELLS)
        can_r, can_d = tile_r > 1, tile_d > STRIP
        if not (too_big(tile_r, tile_d) or too_few) or not (can_r or can_d):
            return tile_r, tile_d
        if can_r and (tile_r >= tile_d or not can_d):
            tiles_r += 1
        else:
            tiles_d += 1


def _row_split(tile_r: int, tile_d: int, win_r: int) -> int:
    """Lanes that share one strip's window rows: those that would otherwise idle."""
    strips = tile_r * (tile_d // STRIP)
    split = 1
    while split < 32 and 2 * split * strips <= _THREADS and 2 * split <= win_r:
        split *= 2
    return split


# --------------------------------------------------------------------------- #
# detection: launch geometry (pure Python) and the two launches
# --------------------------------------------------------------------------- #
class DetectLaunch(NamedTuple):
    """How the detection kernel cuts ``[batch, rows, cols]`` maps into blocks."""

    tile_r: int      #: core rows a tile
    tile_d: int      #: core columns a tile, a multiple of ``STRIP``
    tiles_r: int
    tiles_d: int
    region_r: int    #: rows of a tile's region: ``tile_r + win_r - 1``
    region_d: int    #: its columns: ``tile_d + win_d - 1`` (may overhang the map)
    stride: int      #: 32-bit words a row of a copy of the region, a multiple of 4
    copies: int      #: 2 when the run right of the guard box starts off a 16-byte boundary
    row_split: int   #: lanes that share one strip's window rows (a power of two)
    smem_bytes: int  #: the copies of the scaled region and the tile's mask


def _detect_layout(tile_r: int, tile_d: int, win_r: int, win_d: int, right: int):
    """``(stride, copies, smem_bytes)`` of a tile of the detection kernel.

    A row holds the region and the 3 words a 16-byte load may read past a
    run's end; its stride is congruent to the words of a row's strips modulo
    the 32 banks, so that lanes running on from one row's last strip to the
    next row's first keep reading consecutive banks.
    """
    stride = -(-(tile_d + win_d - 1 + 4) // 4) * 4
    while (stride - tile_d) % 32:
        stride += 4
    copies = 2 if right % 4 else 1
    mask = -(-tile_r * tile_d // 16) * 16
    return stride, copies, 4 * copies * (tile_r + win_r - 1) * stride + mask


@functools.lru_cache(maxsize=256)
def detect_launch_geometry(rows: int, cols: int, num_train, num_guard, batch: int,
                           whole_frame: bool = False) -> DetectLaunch:
    """Tiles, region, row stride and shared memory of one launch of the detection kernel.

    A block takes a tile of core cells and keeps the tile's region (the cells
    and their windows), scaled, in shared memory.  Tiles are cut, the longer
    side first, until a tile needs at most
    ``PREFERRED_DETECT_SHARED_BYTES`` and, for a small batch, until
    ``batch * tiles`` reaches ``_TARGET_BLOCKS`` or a tile is down to
    ``_MIN_TILE_CELLS`` cells; the window rows of a strip are then split over
    the lanes that would otherwise idle.  ``whole_frame``: one tile a frame,
    whatever the batch, as the compacting entry needs.  Raises ``ValueError``
    for a map smaller than one window and for a tile that does not fit
    ``MAX_SHARED_BYTES`` (a whole frame too large, or one window too large).
    ``num_train`` and ``num_guard`` are tuples: the result is cached.
    """
    (tr, td), (gr, gd) = num_train, num_guard
    win_r, win_d = 2 * (tr + gr) + 1, 2 * (td + gd) + 1
    r_out, d_out = rows - win_r + 1, cols - win_d + 1
    if r_out < 1 or d_out < 1:
        raise ValueError(f"a {rows}x{cols} map is smaller than the {win_r}x{win_d} "
                         "window")
    right = td + 2 * gd + 1

    def layout(tile_r, tile_d):
        return _detect_layout(tile_r, tile_d, win_r, win_d, right)

    if whole_frame:
        tile_r, tile_d = r_out, STRIP * -(-d_out // STRIP)
    else:
        tile_r, tile_d = _cut_tiles(
            r_out, d_out, batch,
            lambda tr_, td_: layout(tr_, td_)[2] > PREFERRED_DETECT_SHARED_BYTES)
    stride, copies, smem = layout(tile_r, tile_d)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"a tile of {tile_r}x{tile_d} cells with a {win_r}x{win_d} window "
                         f"needs {smem} bytes of shared memory: a block has "
                         f"{MAX_SHARED_BYTES}")
    return DetectLaunch(tile_r, tile_d, -(-r_out // tile_r), -(-d_out // tile_d),
                        tile_r + win_r - 1, tile_d + win_d - 1, stride, copies,
                        _row_split(tile_r, tile_d, win_r), smem)


def frame_fits_one_block(rows: int, cols: int, num_train, num_guard) -> bool:
    """Whether a block can hold a whole frame's region: the compacting entry's condition."""
    return _whole_frame_fits(rows, cols, tuple(num_train), tuple(num_guard))


@functools.lru_cache(maxsize=256)
def _whole_frame_fits(rows: int, cols: int, num_train, num_guard) -> bool:
    try:
        detect_launch_geometry(rows, cols, num_train, num_guard, 1, whole_frame=True)
    except ValueError:  # smaller than a window, or more than a block's shared memory
        return False
    return True


@functools.cache
def _kernel():
    """The mask entry point, built at first use, with its argument types declared."""
    fn = _build.load("os_cfar_detect").os_cfar_2d_detect
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
        ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _compact_kernel():
    """The compacting entry point, built at first use, with its argument types declared."""
    fn = _build.load("os_cfar_detect").os_cfar_2d_detect_compact
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_window(num_train, num_guard, k: int):
    (tr, td), (gr, gd) = num_train, num_guard
    if min(tr, td, gr, gd) < 0:
        raise ValueError(f"negative window size: train {num_train}, guard {num_guard}")
    if int(k) < 1:
        raise ValueError(f"rank k={k} below 1")
    return (int(tr), int(td)), (int(gr), int(gd))


def os_cfar_2d_detect(
    x: torch.Tensor, *, num_train, num_guard, k: int, alpha: float,
) -> torch.Tensor:
    """Launch the kernel: CUDA ``float32 [B, R, D] -> bool [B, R, D]``.

    ``k`` is the 1-based rank, already computed on the host.  Raises on
    anything the kernel does not take: a tensor off the GPU, a map smaller
    than one window (the caller answers that without a launch), a window too
    large for a block's shared memory.
    """
    _check_maps(x)
    train, guard = _check_window(num_train, num_guard, k)
    b, rows, cols = x.shape
    geo = detect_launch_geometry(rows, cols, train, guard, b)
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    if b == 0:
        return out
    launch = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), b, rows, cols, *train, *guard,
                     int(k), float(alpha), geo.tile_r, geo.tile_d, geo.tiles_r,
                     geo.tiles_d, geo.stride, geo.row_split, stream)
    if err != 0:
        raise RuntimeError(f"os_cfar_2d_detect kernel launch failed: CUDA error {err}")
    os_cfar_2d_detect.launches += 1
    return out


os_cfar_2d_detect.launches = 0


def os_cfar_2d_detect_compact(
    x: torch.Tensor, capacity: int, *, num_train, num_guard, k: int, alpha: float,
):
    """Launch the compacting entry: CUDA ``float32 [B, R, D] -> (rows, cols, valid, count)``.

    The first ``capacity`` detections of every frame in row-major order, as
    ``ops.masked.mask_to_indices_2d`` gives them for the mask: ``rows`` and
    ``cols`` int64 ``[B, capacity]`` (padding 0), ``valid`` bool
    ``[B, capacity]``, ``count`` int32 ``[B]`` clamped to ``capacity``.  One
    block holds a whole frame: raises where :func:`frame_fits_one_block` is
    False, and on anything :func:`os_cfar_2d_detect` raises on.
    """
    _check_maps(x)
    train, guard = _check_window(num_train, num_guard, k)
    if int(capacity) < 1:
        raise ValueError(f"capacity {capacity} below 1")
    b, rows, cols = x.shape
    geo = detect_launch_geometry(rows, cols, train, guard, b, whole_frame=True)
    out_rows, out_cols = torch.empty((2, b, capacity), dtype=torch.int64, device=x.device)
    valid = torch.empty((b, capacity), dtype=torch.bool, device=x.device)
    count = torch.empty((b,), dtype=torch.int32, device=x.device)
    if b == 0:
        return out_rows, out_cols, valid, count
    launch = _compact_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out_rows.data_ptr(), out_cols.data_ptr(),
                     valid.data_ptr(), count.data_ptr(), int(capacity), b, rows, cols,
                     *train, *guard, int(k), float(alpha), geo.tile_r, geo.tile_d,
                     geo.stride, geo.row_split, stream)
    if err != 0:
        raise RuntimeError(f"os_cfar_2d_detect_compact kernel launch failed: CUDA error {err}")
    os_cfar_2d_detect.launches += 1
    return out_rows, out_cols, valid, count


# --------------------------------------------------------------------------- #
# the noise map: launch geometry (pure Python) and launch
# --------------------------------------------------------------------------- #
#: a region (a tile's cells and their windows) is sorted whole by one block:
#: tiles are cut until a region has at most ``PREFERRED_REGION``
#: values; one window that needs more may take up to ``MAX_REGION``
PREFERRED_REGION = 8192
MAX_REGION = 16384


class NoiseLaunch(NamedTuple):
    """How :func:`os_cfar_2d_noise` cuts ``[batch, rows, cols]`` maps into blocks."""

    tile_r: int         #: core rows a tile
    tile_d: int         #: core columns a tile, a multiple of ``STRIP``
    tiles_r: int
    tiles_d: int
    region_r: int       #: rows of a tile's region: ``tile_r + win_r - 1``
    region_d: int       #: its columns: ``tile_d + win_d - 1`` (may overhang the map)
    words_per_row: int  #: 32-bit words a row of a rank copy (two ranks a word), odd
    sort_size: int      #: the bitonic network's size: a power of two >= the region and 256
    passes: int         #: counting passes of the rank search: bits of a rank
    row_split: int      #: lanes that share one strip's window rows (a power of two)
    smem_bytes: int     #: sorted keys (a word of padding every 32) and two copies of the ranks


@functools.lru_cache(maxsize=256)
def noise_launch_geometry(rows: int, cols: int, num_train, num_guard,
                          batch: int) -> NoiseLaunch:
    """Tiles, region, sort size, passes and shared memory of one launch.

    A block takes a tile of core cells, sorts the tile's region (the cells
    and their windows) and searches ranks.  Tiles are cut, the longer side
    first, until a region has at most ``PREFERRED_REGION`` values and, for a
    small batch, until ``batch * tiles`` reaches ``_TARGET_BLOCKS`` or a tile
    is down to ``_MIN_TILE_CELLS`` cells; the window rows of a strip are then
    split over the lanes that would otherwise idle.  Raises ``ValueError``
    for a map smaller than one window and for a window whose region exceeds
    ``MAX_REGION`` values.  ``num_train`` and ``num_guard`` are tuples: the
    result is cached, since a detector asks for the same one every frame.
    """
    (tr, td), (gr, gd) = num_train, num_guard
    win_r, win_d = 2 * (tr + gr) + 1, 2 * (td + gd) + 1
    r_out, d_out = rows - win_r + 1, cols - win_d + 1
    if r_out < 1 or d_out < 1:
        raise ValueError(f"a {rows}x{cols} map is smaller than the {win_r}x{win_d} "
                         "window")
    tile_r, tile_d = _cut_tiles(
        r_out, d_out, batch,
        lambda tr_, td_: (tr_ + win_r - 1) * (td_ + win_d - 1) > PREFERRED_REGION)
    region = (tile_r + win_r - 1) * (tile_d + win_d - 1)
    if region > MAX_REGION:
        raise ValueError(f"a {win_r}x{win_d} window needs a region of {region} values: "
                         f"the kernel sorts at most {MAX_REGION}")
    region_r, region_d = tile_r + win_r - 1, tile_d + win_d - 1
    words_per_row = (region_d // 2 + 1) | 1
    sort_size = max(_THREADS, 1 << (region - 1).bit_length())
    row_split = _row_split(tile_r, tile_d, win_r)
    smem = 4 * (sort_size + sort_size // 32 + 2 * region_r * words_per_row)
    return NoiseLaunch(tile_r, tile_d, -(-r_out // tile_r), -(-d_out // tile_d),
                       region_r, region_d, words_per_row, sort_size,
                       max(1, (region - 1).bit_length()), row_split, smem)


@functools.cache
def _noise_kernel():
    """The noise map's C entry point, built at first use, with its argument types declared."""
    fn = _build.load("os_rank_select").os_cfar_2d_noise
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 16 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def os_cfar_2d_noise(
    x: torch.Tensor, *, num_train, num_guard, k: int,
) -> torch.Tensor:
    """Launch the kernel: CUDA ``float32 [B, R, D] -> float32 [B, R-2er, D-2ed]``.

    The rank-``k`` (1-based, computed on the host) smallest training cell of
    every core cell; ``er``/``ed`` are ``num_train + num_guard`` per axis.
    Raises on anything the kernel does not take: a tensor off the GPU, a map
    smaller than one window (the caller answers that without a launch), ``k``
    outside ``1..n_train``, a window too large to sort in shared memory.
    """
    _check_maps(x)
    (tr, td), (gr, gd) = num_train, num_guard
    if min(tr, td, gr, gd) < 0:
        raise ValueError(f"negative window size: train {num_train}, guard {num_guard}")
    b, rows, cols = x.shape
    geo = noise_launch_geometry(rows, cols, (tr, td), (gr, gd), b)
    win_r, win_d = 2 * (tr + gr) + 1, 2 * (td + gd) + 1
    n_train = win_r * win_d - (2 * gr + 1) * (2 * gd + 1)
    if not 1 <= int(k) <= n_train:
        raise ValueError(f"rank k={k} outside 1..{n_train}")
    out = torch.empty((b, rows - win_r + 1, cols - win_d + 1), dtype=torch.float32,
                      device=x.device)
    if b == 0:
        return out
    launch = _noise_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), b, rows, cols, tr, td, gr, gd,
                     int(k), geo.tile_r, geo.tile_d, geo.tiles_r, geo.tiles_d,
                     geo.words_per_row, geo.sort_size, geo.passes, geo.row_split, stream)
    if err != 0:
        raise RuntimeError(f"os_cfar_2d_noise kernel launch failed: CUDA error {err}")
    os_cfar_2d_noise.launches += 1
    return out


os_cfar_2d_noise.launches = 0
