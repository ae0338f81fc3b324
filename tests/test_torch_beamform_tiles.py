"""The Capon and Bartlett kernel's tiles and stages, and a model of its per-row arithmetic.

The kernel (``csrc/beamform_power.cu``) runs only on the card.  Its tile and
stage geometry is a function of the shape, and ``ops/kernels/beamform.py``
models it (``launch_geometry``, ``tile_runs``, ``row_layout``; the card holds
the model equal to the kernel's host code in ``chip_smoke.py``).  These tests
check the model on the CPU:

- every shape a config under ``configs/`` can give fits the 227 KB of shared
  memory a block may use, with whole rows in a stage;
- the copies that fill a stage are split at frame edges, land each element of
  the tile's rows once, and the kernel reads every row back from where they
  land (tiles that straddle frames, ``W = 1``, odd ``K``, rows longer than a
  stage);
- bulk (TMA) copies are chosen only where every run is 16-byte aligned.

Then a numpy model of what one row's threads compute (eight threads over the
chirps and a shuffle tree, the in-place packed Cholesky and ``L^-1``, the
power of each angle) against the plain versions, at the kernel-vs-plain bar
``rtol = 5e-5`` (the JAX package's kernel-vs-oracle bar,
``tests/test_beamform.py:380,426``; Bartlett also ``atol = 1e-4`` times the
map's maximum, since its covariance form cancels at deep nulls).
"""

import glob
import os

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import load_cfg
from mmwave_radar_processing_tpu_torch.ops import beamform
from mmwave_radar_processing_tpu_torch.ops.kernels import beamform as kernel

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs",
                                        "*.cfg")))
BEAMFORM_RTOL = 5e-5


def _config_shapes(path):
    """``(W, K)`` a config gives: range bins, and chirps a virtual antenna or a raw channel."""
    cfg = load_cfg(path)
    return [(cfg.num_adc_samples, k) for k in sorted({cfg.frame.loops, cfg.chirps_per_frame})]


def test_configs_are_found():
    assert len(CONFIGS) >= 20


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p)[:-4] for p in CONFIGS])
def test_every_config_shape_fits_shared_memory_with_whole_rows(path):
    for w, k in _config_shapes(path):
        assert w <= 256 and k <= 448
        for n_ant in range(1, kernel.MAX_ANTENNAS + 1):
            for m in (1, 64, 181, 2048, 8192):
                for batch in (1, 1024):
                    geo = kernel.launch_geometry(batch * w, n_ant, k, m)
                    assert geo.smem_bytes <= kernel.SMEM_MAX, (w, k, n_ant, m, batch)
                    assert geo.chunk == k and geo.n_chunks == 1
                    assert 1 <= geo.tile_rows <= kernel.MAX_TILE_ROWS
                    held = 8 * geo.tile_rows * n_ant * geo.chunk
                    assert held <= geo.stage_bytes <= kernel.STAGE_CAP
                    assert geo.bulk == (k % 2 == 0)
                    assert geo.tiles * geo.tile_rows >= batch * w > (geo.tiles - 1) * geo.tile_rows
                    # steering in shared memory only when small: the processors'
                    # (12, 2048) grid is read from global memory
                    assert geo.steer_bytes in (0, 8 * n_ant * m)
                    assert (geo.steer_bytes > 0) == (8 * n_ant * m <= kernel.STEER_CAP)


def test_flagship_geometry_streams_whole_tiles_and_fills_the_card():
    flag = kernel.launch_geometry(1024 * 63, 4, 70, 64)
    assert (flag.tile_rows, flag.tiles, flag.chunk, flag.bulk) == (16, 4032, 70, True)
    assert flag.stage_bytes == 16 * 4 * 70 * 8
    # three blocks an SM (228 KB of shared memory, 1 KB reserved a block)
    assert 3 * (flag.smem_bytes + 1024) <= 233472
    # kernel #9's snapshot blocks: the whole tile is one run
    assert kernel.tile_runs(64512, 4, 1, 70, 64, 5, 0) == [(5 * 16 * 280, 16 * 280, 0)]
    # a processor frame (63 rows): a row a tile, 63 blocks
    assert kernel.launch_geometry(63, 12, 70, 64).tile_rows == 1
    # a misaligned x (a view that starts off 16 bytes) takes the 8-byte copies
    assert not kernel.launch_geometry(1024 * 63, 4, 70, 64, aligned=False).bulk


#: (B, A, W, K, M): tiles that straddle frames; W = 1 with N not a multiple of
#: the tile; odd K; a config-sized cube; A = 1; A = 12 at M = 2048; tiles with a
#: head, a whole frame and a tail; rows longer than a stage (chunks of K, odd
#: and even); the smallest shape
TILE_SHAPES = [(67, 4, 63, 70, 64), (4300, 4, 1, 70, 64), (70, 4, 63, 33, 31),
               (17, 4, 256, 192, 64), (300, 1, 16, 70, 64), (3, 12, 63, 70, 2048),
               (700, 2, 7, 10, 8), (2, 16, 3, 500, 64), (3, 16, 2, 401, 5),
               (1, 1, 1, 1, 1)]
TILE_IDS = ["straddle", "w1", "odd_k", "config_cube", "a1", "a12_m2048", "head_whole_tail",
            "chunked", "chunked_odd", "smallest"]


@pytest.mark.parametrize("shape", TILE_SHAPES, ids=TILE_IDS)
def test_stage_fill_lands_every_row_once_and_the_kernel_reads_it_back(shape):
    b, n_ant, w, k, m = shape
    rows = b * w
    geo = kernel.launch_geometry(rows, n_ant, k, m)
    x = np.arange(b * n_ant * w * k, dtype=np.int64)
    cube = x.reshape(b, n_ant, w, k)
    frame, plane = n_ant * w * k, w * k
    seen_rows = np.zeros(rows, bool)
    for tile in range(geo.tiles):
        for chunk in range(geo.n_chunks):
            r0, k0 = tile * geo.tile_rows, chunk * geo.chunk
            n, kc = min(geo.tile_rows, rows - r0), min(geo.chunk, k - k0)
            stage = np.full(geo.stage_bytes // 8, -1, np.int64)
            runs = kernel.tile_runs(rows, n_ant, w, k, m, tile, chunk)
            assert len(runs) <= 2 * n_ant + 1
            for src, length, dst in runs:
                assert length > 0
                if src % frame == 0 and length % frame == 0:
                    assert kc == k  # whole frames: only with whole rows
                else:  # inside one antenna's plane of one frame: split at its edge
                    assert src // plane == (src + length - 1) // plane
                assert (stage[dst:dst + length] == -1).all(), "a stage element landed twice"
                stage[dst:dst + length] = x[src:src + length]
            assert int((stage >= 0).sum()) == n * n_ant * kc
            for row in range(r0, r0 + n):
                off, stride = kernel.row_layout(rows, n_ant, w, k, m, tile, chunk, row)
                fb, fw = divmod(row, w)
                for i in range(n_ant):
                    np.testing.assert_array_equal(stage[off + i * stride:off + i * stride + kc],
                                                  cube[fb, i, fw, k0:k0 + kc])
                seen_rows[row] = True
    assert seen_rows.all()


@pytest.mark.parametrize("shape", TILE_SHAPES, ids=TILE_IDS)
def test_bulk_copies_only_16_byte_aligned_runs(shape):
    b, n_ant, w, k, m = shape
    rows = b * w
    geo = kernel.launch_geometry(rows, n_ant, k, m)
    assert geo.bulk == (k % 2 == 0)
    assert not kernel.launch_geometry(rows, n_ant, k, m, aligned=False).bulk
    assert (kernel.BAR_BYTES % 128, geo.stage_bytes % 128) == (0, 0)
    if not geo.bulk:
        return
    for tile in range(0, geo.tiles, max(1, geo.tiles // 50)):
        for chunk in range(geo.n_chunks):
            for src, length, dst in kernel.tile_runs(rows, n_ant, w, k, m, tile, chunk):
                assert (8 * src % 16, 8 * length % 16, 8 * dst % 16) == (0, 0, 0)


def test_rows_longer_than_a_stage_take_even_chunks_of_k():
    geo = kernel.launch_geometry(6, 16, 500, 64)
    assert (geo.tile_rows, geo.chunk, geo.n_chunks) == (1, 384, 2)
    assert 8 * 16 * geo.chunk <= kernel.STAGE_CAP
    # any K: one antenna of 6,145 chirps still splits into chunks that fit
    geo = kernel.launch_geometry(1, 1, 6145, 3)
    assert geo.chunk % 2 == 0 and geo.n_chunks == 2 and geo.smem_bytes <= kernel.SMEM_MAX


# --------------------------------------------------------------------------- #
# a model of one row's arithmetic, as the kernel orders it
# --------------------------------------------------------------------------- #
def _tri(i, j):
    return i * (i + 1) // 2 + j


def _covariance_model(x):
    """Packed lower triangle of ``X X^H`` (unscaled): 8 threads over the chirps, then a shuffle tree."""
    n_ant, k = x.shape
    partial = np.zeros((kernel.GROUP, n_ant * (n_ant + 1) // 2), np.complex64)
    for g in range(kernel.GROUP):
        for kk in range(g, k, kernel.GROUP):
            v = x[:, kk]
            for i in range(n_ant):
                for j in range(i + 1):
                    partial[g, _tri(i, j)] += v[i] * np.conj(v[j])
    off = kernel.GROUP // 2
    while off:  # butterfly: lane g adds lane g ^ off
        partial = partial + partial[np.arange(kernel.GROUP) ^ off]
        off //= 2
    return partial[0]


def _finish_row_model(c, n_ant, inv_k, loading, capon):
    """The kernel's ``finish_row``: scale; Capon: load, Cholesky and ``L^-1`` in place."""
    f32 = np.float32
    c = (c * f32(inv_k)).astype(np.complex64)
    if not capon:
        return c
    tr = f32(0)
    for i in range(n_ant):
        tr = f32(tr + c[_tri(i, i)].real)
    load = f32(f32(f32(loading) * tr) / f32(n_ant)) + f32(1e-12)
    for i in range(n_ant):
        c[_tri(i, i)] = c[_tri(i, i)].real + load
    inv_d = np.zeros(n_ant, f32)
    for j in range(n_ant):
        s = f32(c[_tri(j, j)].real)
        for kk in range(j):
            s = f32(s - f32(abs(c[_tri(j, kk)]) ** 2))
        d = np.sqrt(max(s, np.finfo(f32).tiny), dtype=f32)
        inv_d[j] = f32(1) / d
        for i in range(j + 1, n_ant):
            t = c[_tri(i, j)]
            for kk in range(j):
                t = t - c[_tri(i, kk)] * np.conj(c[_tri(j, kk)])
            c[_tri(i, j)] = t * inv_d[j]
        c[_tri(j, j)] = d
    for j in range(n_ant):
        c[_tri(j, j)] = inv_d[j]
        for i in range(j + 1, n_ant):
            s = c[_tri(i, j)] * inv_d[j]
            for kk in range(j + 1, i):
                s = s + c[_tri(i, kk)] * c[_tri(kk, j)]
            c[_tri(i, j)] = -s * inv_d[i]
    return c


def _power_model(c, a, capon):
    n_ant = a.shape[0]
    if capon:
        g = np.array([sum(c[_tri(i, j)] * a[j] for j in range(i + 1)) for i in range(n_ant)])
        return np.float32(1) / max(np.float32((np.abs(g) ** 2).sum()), np.finfo(np.float32).tiny)
    p = sum(abs(a[i]) ** 2 * c[_tri(i, i)].real for i in range(n_ant))
    p += sum(2 * (c[_tri(i, j)] * a[j] * np.conj(a[i])).real
             for i in range(n_ant) for j in range(i))
    return np.float32(p)


@pytest.mark.parametrize("n_ant", [1, 2, 4, 7, 12, 16])
@pytest.mark.parametrize("capon", [True, False], ids=["capon", "bartlett"])
def test_row_model_matches_plain_versions(n_ant, capon):
    rng = np.random.default_rng(n_ant)
    b, w, k, m = 2, 3, 33 if n_ant > 8 else 70, 31
    x = (rng.standard_normal((b, n_ant, w, k))
         + 1j * rng.standard_normal((b, n_ant, w, k))).astype(np.complex64)
    steer = beamform.steering_ula(np.linspace(-np.pi, np.pi, m, endpoint=False), n_ant)
    xt = torch.from_numpy(x)
    if capon:
        want = beamform.capon_power_reference(xt, steer, loading=1e-2).numpy()
    else:
        want = beamform.bartlett_power_reference(xt, steer).numpy()
    a = steer.numpy()
    got = np.zeros_like(want)
    for bb in range(b):
        for ww in range(w):
            c = _finish_row_model(_covariance_model(x[bb, :, ww]), n_ant, np.float32(1 / k),
                                  1e-2, capon)
            got[bb, ww] = [_power_model(c, a[:, mm], capon) for mm in range(m)]
    atol = 0.0 if capon else 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=BEAMFORM_RTOL, atol=atol)
