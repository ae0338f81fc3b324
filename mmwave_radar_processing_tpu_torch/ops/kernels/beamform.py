"""Capon and Bartlett power maps: the launches of the hand-written CUDA kernels and their counts.

Replaces three TPU kernels of the JAX package:

- ``capon_power`` replaces ``ops/pallas/capon.py`` ``capon_power_pallas``;
- ``bartlett_power`` replaces ``ops/pallas/capon.py``
  ``bartlett_power_pallas_cov`` and ``ops/pallas/beamform.py``
  ``bartlett_power``, which compute one quantity (``a^H R a = mean_k
  |a^H x_k|^2``) in two layouts; the snapshot blocks ``[N, A, K]`` of the
  second are ``[N, A, 1, K]`` here.

The source is ``csrc/beamform_power.cu``, compiled by ``nvcc`` at first use
(:mod:`._build`): persistent blocks stream tiles of up to 16 consecutive
(frame, range bin) rows through a ring of shared-memory stages filled by
asynchronous copies.  The plain PyTorch versions and the dispatch on the
device live in :mod:`..beamform`.

The tile and stage geometry is a function of the shape, computed by the
kernel's host code; :func:`launch_geometry`, :func:`tile_runs` and
:func:`row_layout` are its model here, for the CPU tests, and
:func:`kernel_launch_geometry` / :func:`kernel_tile_runs` ask the built
library for its own, so that the card can hold the two equal.

``capon_power.launches`` and ``bartlett_power.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mmwave_radar_processing_tpu_torch.ops.kernels import _build

#: the kernels take 1 to MAX_ANTENNAS antennas
MAX_ANTENNAS = 16

# the kernel's constants (csrc/beamform_power.cu)
THREADS = 128
GROUP = 8  # threads that share a row's chirps
MAX_TILE_ROWS = THREADS // GROUP
STAGES = 2
STAGE_CAP = 48 * 1024  # bytes of x a stage holds at most
STEER_CAP = 32 * 1024  # steering staged in shared memory up to this
MIN_TILES = 264  # two per SM of the H100, where the rows allow
BAR_BYTES = 128
#: 227 KB: the shared memory one block may use on the H100
SMEM_MAX = 232448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BeamformLaunch(NamedTuple):
    """The launch geometry of one shape (``make_geometry`` in the source)."""

    tile_rows: int  # consecutive (frame, range bin) rows a tile
    chunk: int  # chirps of a row a stage holds: K unless a row exceeds a stage
    n_chunks: int
    stage_bytes: int  # one stage, a multiple of 128
    cov_bytes: int  # two buffers of a tile's packed covariances
    steer_bytes: int  # steering staged in shared memory (0: read from global)
    smem_bytes: int  # dynamic shared memory of a block
    bulk: bool  # TMA bulk copies (every run 16-byte aligned), else 8-byte cp.async
    tiles: int


def launch_geometry(rows: int, n_ant: int, k_len: int, m_len: int,
                    aligned: bool = True) -> BeamformLaunch:
    """The geometry the kernel takes for ``rows = B * W`` rows of ``[B, A, W, K]`` and ``M`` angles.

    ``aligned``: ``x``'s address is a multiple of 16 bytes.
    """
    row_bytes = 8 * n_ant * k_len
    if row_bytes <= STAGE_CAP:
        chunk, tile_rows = k_len, min(MAX_TILE_ROWS, STAGE_CAP // row_bytes)
    else:
        # even, so that the chunks of an even K start and end on 16 bytes
        chunk, tile_rows = max(2, (STAGE_CAP // (8 * n_ant)) & ~1), 1
    tile_rows = min(tile_rows, max(1, _cdiv(rows, MIN_TILES)))
    stage_bytes = _cdiv(8 * tile_rows * n_ant * chunk, 128) * 128
    cov_bytes = 2 * tile_rows * (n_ant * (n_ant + 1) // 2) * 8
    base = BAR_BYTES + STAGES * stage_bytes + cov_bytes
    steer = 8 * n_ant * m_len
    steer_bytes = steer if steer <= STEER_CAP and base + steer <= SMEM_MAX else 0
    return BeamformLaunch(tile_rows, chunk, _cdiv(k_len, chunk), stage_bytes, cov_bytes,
                          steer_bytes, base + steer_bytes, k_len % 2 == 0 and aligned,
                          _cdiv(rows, tile_rows))


def _tile_span(geo: BeamformLaunch, rows: int, k_len: int, tile: int, chunk: int):
    r0 = tile * geo.tile_rows
    k0 = chunk * geo.chunk
    return r0, min(geo.tile_rows, rows - r0), k0, min(geo.chunk, k_len - k0)


def tile_runs(rows: int, n_ant: int, w_len: int, k_len: int, m_len: int, tile: int,
              chunk: int) -> list[tuple[int, int, int]]:
    """The copies that fill a stage with ``chunk`` of ``tile``: ``(src, len, dst)`` in complex elements.

    The stage holds, for each frame the tile touches, that frame's rows as
    ``[A][rows][kc]``: antenna i's rows of a partly covered frame are one run
    of ``x`` (split at the frame's edge), and whole frames one run together.
    """
    geo = launch_geometry(rows, n_ant, k_len, m_len)
    r0, n, k0, kc = _tile_span(geo, rows, k_len, tile, chunk)
    b0, w0 = divmod(r0, w_len)
    whole_rows = kc == k_len  # else n == 1: one row, one chunk
    n_head = min(n, w_len - w0) if (w0 > 0 or n < w_len or not whole_rows) else 0
    n_whole, n_tail = divmod(n - n_head, w_len)
    b1 = b0 + (1 if n_head else 0)
    frame = n_ant * w_len * k_len
    runs = []
    if n_head:
        runs += [(((b0 * n_ant + i) * w_len + w0) * k_len + k0, n_head * kc, i * n_head * kc)
                 for i in range(n_ant)]
    if n_whole:
        runs.append((b1 * frame, n_whole * frame, n_head * n_ant * kc))
    if n_tail:
        base = (n_head + n_whole * w_len) * n_ant * kc
        runs += [(((b1 + n_whole) * n_ant + i) * w_len * k_len, n_tail * k_len,
                  base + i * n_tail * k_len) for i in range(n_ant)]
    return runs


def row_layout(rows: int, n_ant: int, w_len: int, k_len: int, m_len: int, tile: int,
               chunk: int, row: int) -> tuple[int, int]:
    """Where the kernel reads ``row`` in its tile's stage: ``(offset, antenna stride)`` in elements."""
    geo = launch_geometry(rows, n_ant, k_len, m_len)
    r0, n, _, kc = _tile_span(geo, rows, k_len, tile, chunk)
    b = row // w_len
    seg0, seg1 = max(r0, b * w_len), min(r0 + n, (b + 1) * w_len)
    return (seg0 - r0) * n_ant * kc + (row - seg0) * kc, (seg1 - seg0) * kc


@functools.cache
def _entry(name: str):
    """A C entry point of the library, built at first use, with its argument types."""
    fn = getattr(_build.load("beamform_power"), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_launch_geometry(rows: int, n_ant: int, k_len: int, m_len: int,
                           aligned: bool = True) -> BeamformLaunch:
    """The built library's own :func:`launch_geometry` (its host code; builds it at first use)."""
    fn = _host_entry("beamform_geometry")
    out = (ctypes.c_longlong * 9)()
    if fn(rows, n_ant, k_len, m_len, int(aligned), out) != 0:
        raise ValueError(f"no geometry for rows {rows}, A={n_ant}, K={k_len}, M={m_len}")
    values = list(out)
    values[7] = bool(values[7])
    return BeamformLaunch(*values)


def kernel_tile_runs(rows: int, n_ant: int, w_len: int, k_len: int, m_len: int, tile: int,
                     chunk: int) -> list[tuple[int, int, int]]:
    """The built library's own :func:`tile_runs`."""
    fn = _host_entry("beamform_tile_runs")
    out = (ctypes.c_longlong * (3 * (2 * MAX_ANTENNAS + 1)))()
    n = fn(rows, n_ant, w_len, k_len, m_len, tile, chunk, out)
    if n < 0:
        raise ValueError(f"no tile {tile}, chunk {chunk} at rows {rows}, A={n_ant} "
                         f"W={w_len} K={k_len}")
    return [tuple(out[3 * r:3 * r + 3]) for r in range(n)]


#: argument types of the library's host entry points (after ``rows``, before ``out``)
_HOST_ARGS = {
    "beamform_geometry": [ctypes.c_int] * 4,  # n_ant, k_len, m_len, aligned
    "beamform_tile_runs": [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int],
}


@functools.cache
def _host_entry(name: str):
    fn = getattr(_build.load("beamform_power"), name)
    fn.argtypes = [ctypes.c_longlong, *_HOST_ARGS[name], ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, name: str, x: torch.Tensor, steering: torch.Tensor,
            loading: float) -> torch.Tensor:
    """Check what the kernel takes, allocate ``[B, W, M]``, launch ``name`` and count it on ``wrapper``."""
    for t in (x, steering):
        if t.dtype != torch.complex64:
            raise TypeError(f"expected complex64 tensors, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"the beamforming kernels need CUDA tensors, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    if x.dim() != 4 or steering.dim() != 2 or steering.shape[0] != x.shape[1]:
        raise ValueError(f"expected x [B, A, W, K] and steering (A, M), got "
                         f"{tuple(x.shape)} and {tuple(steering.shape)}")
    b, n_ant, w, k = x.shape
    m = steering.shape[1]
    if not 1 <= n_ant <= MAX_ANTENNAS:
        raise ValueError(f"{n_ant} antennas: the kernels take 1 to {MAX_ANTENNAS}")
    if k < 1:
        raise ValueError("no snapshots (K = 0): the covariance is undefined")
    out = torch.empty((b, w, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    launch = _entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # complex64 is read in place as interleaved (re, im) float pairs
        err = launch(x.data_ptr(), steering.data_ptr(), out.data_ptr(),
                     b * w, n_ant, w, k, m, loading, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def capon_power(x: torch.Tensor, steering: torch.Tensor, *,
                loading: float) -> torch.Tensor:
    """Launch the Capon kernel: CUDA complex64 ``[B, A, W, K]``, ``(A, M)`` -> float32 ``[B, W, M]``.

    Raises on anything the kernel does not take: a tensor off the GPU, not
    contiguous, not complex64, or more than ``MAX_ANTENNAS`` antennas.
    """
    return _launch(capon_power, "capon_power", x, steering, float(loading))


def bartlett_power(x: torch.Tensor, steering: torch.Tensor) -> torch.Tensor:
    """Launch the Bartlett kernel: the same inputs and output as :func:`capon_power`."""
    return _launch(bartlett_power, "bartlett_power", x, steering, 0.0)


capon_power.launches = 0
bartlett_power.launches = 0
