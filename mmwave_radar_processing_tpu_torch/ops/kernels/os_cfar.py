"""OS-CFAR 2D: the launches of the two hand-written CUDA kernels and their counts.

:func:`os_cfar_2d_detect` replaces the TPU kernel
``ops/pallas/os_cfar.py::os_cfar_2d_detect_fused`` of the JAX package (source
``csrc/os_cfar_detect.cu``: one thread block per frame, the map in shared
memory), and :func:`os_cfar_2d_noise` replaces
``ops/pallas/os_cfar.py::os_cfar_2d_noise_fused`` (source
``csrc/os_rank_select.cu``: a block sorts a tile's region, replaces every
value by its rank and searches each window's k-th smallest rank;
:func:`noise_launch_geometry` cuts a map into tiles).  Both are compiled by
``nvcc`` at first use (:mod:`._build`).  The window geometry, the rank ``k``,
the plain PyTorch versions and the dispatch on the device live in
:mod:`..cfar`.

``os_cfar_2d_detect.launches`` and ``os_cfar_2d_noise.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: the detection kernel keeps one map in shared memory: at most 227 KB a block on Hopper
MAX_MAP_CELLS = 232448 // 4


@functools.cache
def _kernel():
    """The C entry point, built at first use, with its argument types declared."""
    fn = _build.load("os_cfar_detect").os_cfar_2d_detect
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def os_cfar_2d_detect(
    x: torch.Tensor, *, num_train, num_guard, k: int, alpha: float,
) -> torch.Tensor:
    """Launch the kernel: CUDA ``float32 [B, R, D] -> bool [B, R, D]``.

    ``k`` is the 1-based rank, already computed on the host.  Raises on
    anything the kernel does not take, a tensor off the GPU included.
    """
    _check_maps(x)
    b, rows, cols = x.shape
    if rows * cols > MAX_MAP_CELLS:
        raise ValueError(f"a {rows}x{cols} map does not fit in shared memory "
                         f"(at most {MAX_MAP_CELLS} cells)")
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    if b == 0:
        return out
    (tr, td), (gr, gd) = num_train, num_guard
    launch = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), b, rows, cols, tr, td, gr,
                     gd, int(k), float(alpha), stream)
    if err != 0:
        raise RuntimeError(f"os_cfar_2d_detect kernel launch failed: CUDA error {err}")
    os_cfar_2d_detect.launches += 1
    return out


os_cfar_2d_detect.launches = 0


# --------------------------------------------------------------------------- #
# the noise map: launch geometry (pure Python) and launch
# --------------------------------------------------------------------------- #
_THREADS = 256  # kThreads of csrc/os_rank_select.cu
#: cells a thread selects for: a strip of 4 neighbours in a row
STRIP = 4
#: a region (a tile's cells and their windows) is sorted whole by one block:
#: tiles are cut until a region has at most ``PREFERRED_REGION``
#: values; one window that needs more may take up to ``MAX_REGION``
PREFERRED_REGION = 8192
MAX_REGION = 16384
#: blocks wanted in flight (one for each of an H100's 132 SMs), and the tile
#: below which a small batch is not cut further
_TARGET_BLOCKS = 132
_MIN_TILE_CELLS = 64


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
    tiles_r = tiles_d = 1
    while True:
        tile_r = -(-r_out // tiles_r)
        tile_d = STRIP * -(-(-(-d_out // tiles_d)) // STRIP)
        region = (tile_r + win_r - 1) * (tile_d + win_d - 1)
        n_tiles = -(-r_out // tile_r) * -(-d_out // tile_d)
        too_few = (max(batch, 1) * n_tiles < _TARGET_BLOCKS
                   and tile_r * tile_d > _MIN_TILE_CELLS)
        can_r, can_d = tile_r > 1, tile_d > STRIP
        if not (region > PREFERRED_REGION or too_few) or not (can_r or can_d):
            break
        if can_r and (tile_r >= tile_d or not can_d):
            tiles_r += 1
        else:
            tiles_d += 1
    if region > MAX_REGION:
        raise ValueError(f"a {win_r}x{win_d} window needs a region of {region} values: "
                         f"the kernel sorts at most {MAX_REGION}")
    region_r, region_d = tile_r + win_r - 1, tile_d + win_d - 1
    words_per_row = (region_d // 2 + 1) | 1
    sort_size = max(_THREADS, 1 << (region - 1).bit_length())
    strips = tile_r * (tile_d // STRIP)
    row_split = 1
    while row_split < 32 and 2 * row_split * strips <= _THREADS and 2 * row_split <= win_r:
        row_split *= 2
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
