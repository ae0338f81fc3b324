"""The redesigned noise-map and response kernels, as far as a CPU can hold them.

The CUDA kernels run only on a card (``tests/test_torch_cuda.py``).  Here:

- the noise map's launch geometry (:func:`noise_launch_geometry`, pure
  Python): tiles cover every core cell exactly once, a region fits the sort
  and shared memory;
- a torch model of the kernel's algorithm, tile by tile with that geometry
  (sort a tile's region, replace values by ranks, search the k-th smallest
  rank bit by bit, read the value back), equal to the plain version and to
  the JAX package's ``os_2d`` noise on maps with ties and ``+inf``;
- the response kernel's plain version against the JAX kernels at angle
  counts that leave 1, 2 and 3 bins in the last block of 4 a thread takes, at
  one, three and five antennas a set, and in the paired layout.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
from mmwave_radar_processing_tpu.ops import cfar as jcfar
from mmwave_radar_processing_tpu.ops.pallas import doppler_az as jdoppler_az
from mmwave_radar_processing_tpu_torch.ops import cfar, doppler_az
from mmwave_radar_processing_tpu_torch.ops.kernels import os_cfar as kernel

torch.set_num_threads(2)

FLAGSHIP = dict(num_train=(5, 5), num_guard=(3, 2))
SECOND = dict(num_train=(4, 6), num_guard=(2, 1))
ZERO_GUARD = dict(num_train=(3, 2), num_guard=(0, 0))
NARROW = dict(num_train=(2, 1), num_guard=(1, 0))  # a 3-column window
TALL = dict(num_train=(40, 30), num_guard=(2, 2))  # one window is 85 x 65 = 5525 cells
HUGE = dict(num_train=(48, 40), num_guard=(2, 2))  # 101 x 85 = 8585 cells: the largest sort

GEOMETRY_CASES = [
    (63, 70, FLAGSHIP, 1024), (63, 70, FLAGSHIP, 64), (63, 70, FLAGSHIP, 7),
    (63, 70, FLAGSHIP, 1), (17, 15, FLAGSHIP, 3), (18, 15, FLAGSHIP, 1),
    (17, 20, FLAGSHIP, 1), (64, 128, SECOND, 5), (256, 192, FLAGSHIP, 2),
    (256, 192, FLAGSHIP, 1024), (63, 70, ZERO_GUARD, 7), (63, 70, ZERO_GUARD, 1),
    (63, 70, NARROW, 1), (90, 70, TALL, 1), (256, 192, TALL, 4), (104, 90, HUGE, 3),
]
GEOMETRY_IDS = [f"{r}x{c}_t{kw['num_train'][0]}{kw['num_train'][1]}"
                f"g{kw['num_guard'][0]}{kw['num_guard'][1]}_b{b}"
                for r, c, kw, b in GEOMETRY_CASES]


def _window(kw):
    (tr, td), (gr, gd) = kw["num_train"], kw["num_guard"]
    return 2 * (tr + gr) + 1, 2 * (td + gd) + 1


@pytest.mark.parametrize("rows,cols,kw,batch", GEOMETRY_CASES, ids=GEOMETRY_IDS)
def test_noise_tiles_cover_every_core_cell_exactly_once(rows, cols, kw, batch):
    geo = kernel.noise_launch_geometry(rows, cols, kw["num_train"], kw["num_guard"], batch)
    win_r, win_d = _window(kw)
    r_out, d_out = rows - win_r + 1, cols - win_d + 1
    covered = np.zeros((r_out, d_out), np.int32)
    for tile_r in range(geo.tiles_r):
        for tile_d in range(geo.tiles_d):
            r0, c0 = tile_r * geo.tile_r, tile_d * geo.tile_d
            assert r0 < r_out and c0 < d_out, "an empty tile"
            covered[r0 : r0 + geo.tile_r, c0 : c0 + geo.tile_d] += 1
    assert (covered == 1).all()
    assert geo.tile_d % kernel.STRIP == 0


@pytest.mark.parametrize("rows,cols,kw,batch", GEOMETRY_CASES, ids=GEOMETRY_IDS)
def test_noise_region_fits_the_sort_and_shared_memory(rows, cols, kw, batch):
    geo = kernel.noise_launch_geometry(rows, cols, kw["num_train"], kw["num_guard"], batch)
    win_r, win_d = _window(kw)
    assert geo.region_r == geo.tile_r + win_r - 1
    assert geo.region_d == geo.tile_d + win_d - 1
    region = geo.region_r * geo.region_d
    assert region <= geo.sort_size <= kernel.MAX_REGION
    assert geo.sort_size & (geo.sort_size - 1) == 0
    assert geo.sort_size < 2 * region or geo.sort_size == 256  # a thread sorts >= 1 key
    assert (1 << geo.passes) >= region, "a rank needs `passes` bits"
    # a window wider than the preferred region is the only reason to exceed it
    if region > kernel.PREFERRED_REGION:
        assert geo.tile_r == 1 or geo.tile_d == kernel.STRIP or win_r * win_d > 2048
    # a row of a rank copy holds the region and the shifted copy's overhang; odd
    assert 2 * geo.words_per_row >= geo.region_d + 1 and geo.words_per_row % 2 == 1
    assert geo.smem_bytes == 4 * (geo.sort_size + geo.sort_size // 32
                                  + 2 * geo.region_r * geo.words_per_row)
    assert geo.smem_bytes <= 227 * 1024
    # every rank, offset by the smallest normal half, stays a finite half
    assert (1 << geo.passes) - 1 + 0x0400 <= 0x7BFF
    # lanes that share a strip: a power of two inside a warp, no more than window rows
    assert geo.row_split in (1, 2, 4, 8, 16, 32) and geo.row_split <= win_r
    assert geo.row_split == 1 or geo.row_split * geo.tile_r * geo.tile_d // 4 <= 256
    # a lane's compare masks sum in 16 bits a half word: fewer than 65536 a lane
    assert win_r * (win_d // 2 + 2) < 65536


def test_noise_geometry_fills_the_card_at_any_batch():
    for batch in (1, 7, 64, 1024):
        geo = kernel.noise_launch_geometry(63, 70, (5, 5), (3, 2), batch)
        blocks = batch * geo.tiles_r * geo.tiles_d
        assert blocks >= 132 or geo.tile_r * geo.tile_d <= 64
    whole = kernel.noise_launch_geometry(63, 70, (5, 5), (3, 2), 1024)
    assert (whole.tiles_r, whole.tiles_d, whole.sort_size, whole.passes) == (1, 1, 8192, 13)
    large = kernel.noise_launch_geometry(256, 192, (5, 5), (3, 2), 2)
    assert large.passes <= 13 and large.smem_bytes < 64 * 1024


@pytest.mark.parametrize("rows,cols,kw,match", [
    (16, 15, FLAGSHIP, "smaller than"), (17, 14, FLAGSHIP, "smaller than"),
    (300, 300, dict(num_train=(60, 60), num_guard=(4, 4)), "sorts at most"),
    (3, 40000, dict(num_train=(0, 8200), num_guard=(0, 0)), "sorts at most"),
])
def test_noise_geometry_rejects_what_the_kernel_does_not_take(rows, cols, kw, match):
    with pytest.raises(ValueError, match=match):
        kernel.noise_launch_geometry(rows, cols, kw["num_train"], kw["num_guard"], 1)


# --------------------------------------------------------------------------- #
# a torch model of the kernel: rank transform of a region, k-th smallest rank, value
# --------------------------------------------------------------------------- #
def _keys(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving integer image of float32 (as int64): the kernel's ``float_to_key``."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)


def noise_by_rank_search(x: torch.Tensor, *, num_train, num_guard, k: int) -> torch.Tensor:
    """The kernel's algorithm in torch, with its launch geometry, on ``[B, R, D]``."""
    b, rows, cols = x.shape
    geo = kernel.noise_launch_geometry(rows, cols, num_train, num_guard, b)
    mask = torch.from_numpy(cfar.train_mask_2d(num_train, num_guard))
    win_r, win_d = mask.shape
    r_out, d_out = rows - win_r + 1, cols - win_d + 1
    out = torch.full((b, r_out, d_out), float("nan"))
    written = torch.zeros((r_out, d_out), dtype=torch.int32)
    for r0 in range(0, r_out, geo.tile_r):
        for c0 in range(0, d_out, geo.tile_d):
            cells_r, cells_d = min(geo.tile_r, r_out - r0), min(geo.tile_d, d_out - c0)
            region = x[:, r0 : r0 + cells_r + win_r - 1, c0 : c0 + cells_d + win_d - 1]
            assert region[0].numel() <= geo.sort_size
            keys = _keys(region)
            sorted_keys, _ = torch.sort(keys.reshape(b, -1), dim=1)
            # rank = the number of keys below: ties share a rank
            ranks = torch.searchsorted(sorted_keys, keys.reshape(b, -1)).reshape(keys.shape)
            assert int(ranks.max()) < (1 << geo.passes)
            windows = ranks.unfold(1, win_r, 1).unfold(2, win_d, 1)[..., mask]  # [B, r, d, n]
            v = torch.zeros(windows.shape[:3], dtype=torch.int64)
            for bit in range(geo.passes - 1, -1, -1):
                t = v | (1 << bit)
                below = (windows < t[..., None]).sum(-1)
                v = torch.where(below < k, t, v)
            value_keys = torch.gather(sorted_keys, 1, v.reshape(b, -1)).reshape(v.shape)
            bits = torch.where(value_keys >= 0x80000000, value_keys ^ 0x80000000,
                               value_keys ^ 0xFFFFFFFF)
            signed = torch.where(bits >= 0x80000000, bits - (1 << 32), bits)
            values = signed.to(torch.int32).view(torch.float32)
            out[:, r0 : r0 + cells_r, c0 : c0 + cells_d] = values
            written[r0 : r0 + cells_r, c0 : c0 + cells_d] += 1
    assert bool((written == 1).all())
    return out


def _maps(shape, seed):
    """Quantized exponential maps (ties), negatives, both zeros and ``+inf``."""
    rng = np.random.default_rng(seed)
    x = (np.round(rng.exponential(1.0, shape) * 8) / 8 - 0.25).astype(np.float32)
    x[..., ::5, ::3] = np.inf
    x[..., 1::7, 2::4] = -0.0
    x[..., 3::7, 1::4] = 0.0
    return x


MODEL_CASES = [((2, 63, 70), FLAGSHIP, 0.7), ((1, 63, 70), FLAGSHIP, 0.7),
               ((3, 17, 15), FLAGSHIP, 0.7), ((1, 18, 16), FLAGSHIP, 0.3),
               ((2, 40, 50), SECOND, 0.5), ((1, 40, 50), ZERO_GUARD, 0.5),
               ((1, 30, 31), NARROW, 0.9), ((1, 30, 31), NARROW, 0.01)]
MODEL_IDS = ["flagship_b2", "flagship_b1_tiled", "one_window", "one_tile_plus_a_cell",
             "second", "zero_guard", "narrow_high", "narrow_k1"]


@pytest.mark.parametrize("shape,kw,rho", MODEL_CASES, ids=MODEL_IDS)
def test_rank_search_model_equals_plain_version(shape, kw, rho):
    x = torch.from_numpy(_maps(shape, seed=shape[1]))
    k = cfar._geometry(kw["num_train"], kw["num_guard"], rho)[3]
    got = noise_by_rank_search(x, k=k, **kw)
    want = cfar.os_2d_noise_reference(x, k=k, **kw)
    assert got.shape == want.shape
    assert torch.equal(got, want)  # ==: -0.0 and +0.0 are one value


@pytest.mark.parametrize("shape,kw,rho", MODEL_CASES[:6], ids=MODEL_IDS[:6])
def test_rank_search_model_equals_jax_os_2d_noise(shape, kw, rho):
    x = _maps(shape, seed=shape[2])
    k = cfar._geometry(kw["num_train"], kw["num_guard"], rho)[3]
    got = noise_by_rank_search(torch.from_numpy(x), k=k, **kw)
    _, noise = jcfar.os_2d(x, rho=rho, alpha=2.0, **kw)
    er, ed = (n + g for n, g in zip(kw["num_train"], kw["num_guard"]))
    core = np.asarray(noise)[:, er : shape[1] - er, ed : shape[2] - ed]
    np.testing.assert_array_equal(got.numpy(), core)


def test_rank_search_model_takes_the_same_passes_on_any_data():
    """The search runs over ranks: its pass count depends on the region's size alone."""
    geo = kernel.noise_launch_geometry(63, 70, (5, 5), (3, 2), 1024)
    assert geo.passes == 13 < 32
    x = torch.from_numpy(np.random.default_rng(0).exponential(1.0, (1, 63, 70))
                         .astype(np.float32))
    for scale in (1.0, 1e-30, 1e30):
        got = noise_by_rank_search(x * scale, k=154, **FLAGSHIP)
        assert torch.equal(got, cfar.os_2d_noise_reference(x * scale, k=154, **FLAGSHIP))


def test_os_2d_on_the_cpu_never_reaches_the_kernel():
    x = torch.from_numpy(_maps((2, 30, 31), seed=1))
    before = kernel.os_cfar_2d_noise.launches
    cfar.os_2d(x, rho=0.5, alpha=2.0, **FLAGSHIP)
    assert kernel.os_cfar_2d_noise.launches == before
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernel.os_cfar_2d_noise(x, k=100, **FLAGSHIP)


# --------------------------------------------------------------------------- #
# the response kernel: odd shapes of its plain version
# --------------------------------------------------------------------------- #
SETS = ((0, 3, 4, 7), (1, 2, 5, 6), (10, 11, 6, 7), (9, 8, 5, 4))


def _spectra(b, n_ch, w, nv, av, n_cols, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n_ch, w * nv)).astype(np.float32),
            rng.standard_normal((b, n_ch, w * nv)).astype(np.float32),
            rng.uniform(0, 1, (b, w)).astype(np.float32),
            rng.standard_normal((av, n_cols)).astype(np.float32),
            rng.standard_normal((av, n_cols)).astype(np.float32))


@pytest.mark.parametrize("av,sets", [
    (7, SETS),
    (13, ((0, 3, 4), (1, 2, 5), (10, 11, 6))),
    (60, ((0, 3, 4), (9, 8, 5))),
    (11, ((0, 1, 2, 3, 4), (5, 6, 7, 8, 9))),
    (1, SETS), (2, SETS), (5, SETS), (6, SETS), (61, SETS),
    (62, ((0, 3, 4), (9, 8, 5))),
    (9, ((3,), (7,))),
], ids=["av7_rx4", "av13_rx3", "av60_rx3", "av11_rx5", "av1_rx4", "av2_rx4", "av5_rx4",
        "av6_rx4", "av61_rx4", "av62_rx3", "av9_rx1"])
def test_plain_responses_equal_jax_kernel_at_odd_angle_and_antenna_counts(av, sets):
    """Interpret-mode Mosaic orders and contracts the sums its own way: 1e-5."""
    n_cols = len(sets) * len(sets[0])
    args = _spectra(3, 12, 5, 16, av, n_cols, seed=av)
    want = jdoppler_az.set_responses_pallas_batch(*args, set_idx=sets, nv=16,
                                                  interpret=True)
    got = doppler_az.set_responses(*(torch.from_numpy(a) for a in args), set_idx=sets,
                                   nv=16)
    assert got.shape == (3, len(sets), av, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("av,n_rx", [(5, 4), (7, 4), (10, 3), (61, 4)],
                         ids=["av5_rx4", "av7_rx4", "av10_rx3", "av61_rx4"])
def test_plain_responses_equal_jax_paired_kernel_at_odd_angle_counts(av, n_rx):
    """The paired layout: the identity channel table, two sets side by side on ``2*nv``."""
    args = _spectra(2, 2 * n_rx, 5, 16, av, 2 * n_rx, seed=100 + av)
    want = jdoppler_az.group_responses_pallas_batch(*args, n_groups=2, n_rx=n_rx, nv2=16,
                                                    interpret=True)
    got = doppler_az.group_responses(*(torch.from_numpy(a) for a in args), n_groups=2,
                                     n_rx=n_rx, nv2=16)
    assert got.shape == (2, 2, av, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
