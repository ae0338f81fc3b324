"""The redesigned k-th-smallest and detection kernels, as far as a CPU can hold them.

The CUDA kernels run only on a card (``tests/test_torch_cuda.py``).  Here, with
exact equality throughout (every result is one of the inputs, or a count):

- the sorting networks that the build writes into the k-th-smallest kernel
  (:mod:`sorting_network`): each sorts (0-1 principle, exhaustive up to 16
  inputs; seeded keys with ties, ``+inf`` and both zeros above), and the pruned
  list is the padded network less exactly the compare-exchanges that a pad
  would make idle;
- a numpy model of that kernel's narrow form (integer image, network, a tree
  of selects for register ``k - 1``), of its warp-wide bitonic form and of its
  bitwise search, each equal to the plain version and to the JAX package's
  ``kth_smallest`` in interpret mode;
- the detection kernel's launch geometry: tiles cover every interior cell
  once, the written rectangles every map cell once, vector loads stay inside a
  row; a numpy model of the kernel (scale once, two copies, three bands, strips
  of 4, the lanes of a split) equal to the plain version and to the JAX
  package's ``os_2d_detect``; a model of the compacting epilogue equal to
  ``mask_to_indices_2d``;
- ``os_2d_detect_compact`` on the CPU equal to the JAX package's
  ``mask_to_indices_2d(os_2d_detect(...))``.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
from mmwave_radar_processing_tpu.ops import cfar as jcfar
from mmwave_radar_processing_tpu.ops import masked as jmasked
from mmwave_radar_processing_tpu.ops.pallas.rank_select import kth_smallest as jax_kth_smallest
from mmwave_radar_processing_tpu_torch.ops import cfar, masked
from mmwave_radar_processing_tpu_torch.ops.kernels import os_cfar as kernel
from mmwave_radar_processing_tpu_torch.ops.kernels import rank_select, sorting_network
from mmwave_radar_processing_tpu_torch.ops.kernels import _build

torch.set_num_threads(2)

WIDTHS = (1, 3, 4, 8, 9, 16, 17, 24, 31, 32)


# --------------------------------------------------------------------------- #
# the sorting networks
# --------------------------------------------------------------------------- #
def _apply(network, keys):
    """Run compare-exchanges ``(i, j)`` over the columns of ``keys`` (a copy)."""
    keys = keys.copy()
    for i, j in network:
        lo, hi = np.minimum(keys[:, i], keys[:, j]), np.maximum(keys[:, i], keys[:, j])
        keys[:, i], keys[:, j] = lo, hi
    return keys


@pytest.mark.parametrize("width", range(1, 17))
def test_network_sorts_every_zero_one_input(width):
    """0-1 principle: a network that sorts every 0-1 input sorts every input."""
    inputs = np.array(list(itertools.product((0, 1), repeat=width)), np.uint8)
    out = _apply(sorting_network.comparators(width), inputs)
    assert (np.diff(out.astype(np.int8), axis=1) >= 0).all()


def _float_rows(m, w, seed):
    """Quantized values (ties), negatives, both zeros and ``+inf``; a row of one value."""
    rng = np.random.default_rng(seed)
    x = (np.round(rng.exponential(1.0, (m, w)) * 8) / 8 - 0.5).astype(np.float32)
    x[0, ::2] = np.inf
    x[2 % m, ::3] = -0.0
    x[3 % m, 1::3] = 0.0
    if m > 1:
        x[1] = x[1, 0]
    return x


def _keys(x):
    """The kernel's ``float_to_key``: unsigned order is float order."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return np.where(bits & 0x80000000, bits ^ 0xFFFFFFFF, bits ^ 0x80000000).astype(np.uint32)


def _floats(keys):
    """The kernel's ``key_to_float``."""
    keys = keys.astype(np.uint32)
    bits = np.where(keys & 0x80000000, keys ^ 0x80000000, keys ^ 0xFFFFFFFF).astype(np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("width", range(17, 33))
def test_network_sorts_seeded_keys_with_ties_inf_and_zeros(width):
    keys = _keys(_float_rows(400, width, seed=width))
    out = _apply(sorting_network.comparators(width), keys)
    np.testing.assert_array_equal(out, np.sort(keys, axis=1))
    # and a sample of 0-1 inputs, where an exhaustive run would take 2^width
    bits = np.random.default_rng(width).integers(0, 2, (4000, width)).astype(np.uint8)
    assert (np.diff(_apply(sorting_network.comparators(width), bits).astype(np.int8)) >= 0).all()


@pytest.mark.parametrize("width", range(1, 33))
def test_pruned_network_never_touches_a_pad(width):
    padded = 1 << (width - 1).bit_length()
    full = sorting_network.batcher_comparators(padded)
    pruned = list(sorting_network.comparators(width))
    assert all(0 <= i < j < width for i, j in pruned)
    assert pruned == [c for c in full if c[1] < width]  # the same order of use
    # what was dropped has a pad on its upper side, where the largest key
    # already sits: the padded network leaves the pads alone
    keys = np.full((50, padded), 0xFFFFFFFF, np.uint32)
    keys[:, :width] = _keys(_float_rows(50, width, seed=100 + width))
    np.testing.assert_array_equal(_apply(full, keys)[:, :width], _apply(pruned, keys)[:, :width])
    assert (_apply(full, keys)[:, width:] == 0xFFFFFFFF).all()


def test_network_sizes():
    assert len(sorting_network.batcher_comparators(32)) == 191
    assert len(sorting_network.comparators(24)) == 132
    assert [len(sorting_network.comparators(w)) for w in (1, 2, 4, 8, 16)] == [0, 1, 5, 19, 63]
    with pytest.raises(ValueError):
        sorting_network.comparators(33)
    with pytest.raises(ValueError):
        sorting_network.batcher_comparators(24)


def test_header_carries_every_width_and_the_build_knows_it():
    text = sorting_network.header()
    for width in range(1, 33):
        assert f"kth_sort_network<{width}>(uint32_t (&key)[{width}])" in text
    assert text.count("KTH_CE(") == sum(len(sorting_network.comparators(w))
                                        for w in range(1, 33))
    assert _build.generated_headers("os_rank_select") == {sorting_network.HEADER_NAME: text}
    assert _build.generated_headers("os_cfar_detect") == {}
    # an edited header gives another library
    before = _build.library_path("os_rank_select")
    original = _build.GENERATED_HEADERS["os_rank_select"]
    try:
        _build.GENERATED_HEADERS["os_rank_select"] = {
            sorting_network.HEADER_NAME: lambda: text + "// edited\n"}
        assert _build.library_path("os_rank_select") != before
    finally:
        _build.GENERATED_HEADERS["os_rank_select"] = original
    assert _build.library_path("os_rank_select") == before


# --------------------------------------------------------------------------- #
# numpy models of the k-th-smallest kernel's forms
# --------------------------------------------------------------------------- #
def _select_register(keys, idx):
    """The kernel's tree of selects: ``keys[:, idx]`` without an index."""
    n = keys.shape[1]
    padded = 1 << (n - 1).bit_length() if n > 1 else 1
    t = [keys[:, min(i, n - 1)] for i in range(padded)]
    bit = 0
    while (padded >> bit) > 1:
        odd = (idx >> bit) & 1
        for i in range((padded >> bit) // 2):
            t[i] = t[2 * i + 1] if odd else t[2 * i]
        bit += 1
    return t[0]


def kth_by_network(x, k):
    keys = _apply(sorting_network.comparators(x.shape[1]), _keys(x))
    return _floats(_select_register(keys, k - 1))


def _warp_sort(keys, per_lane):
    """The kernel's bitonic network over 32 lanes: position ``lane * per_lane + slot``.

    The first step of a merge pairs ``i`` with ``i ^ (size - 1)``, the others
    ``i`` with ``i ^ j``; the smaller key always goes to the lower position.
    """
    n = 32 * per_lane
    keys = keys.copy()
    pos = np.arange(n)
    size = 2
    while size <= n:
        steps = [pos ^ (size - 1)] + [pos ^ j for j in
                                      (size >> s for s in range(2, size.bit_length()))]
        for partner in steps:
            other = keys[:, partner]
            keys = np.where(pos < partner, np.minimum(keys, other), np.maximum(keys, other))
        size <<= 1
    return keys


def kth_by_warp_sort(x, k):
    m, w = x.shape
    per_lane = 2 if w <= 64 else 4 if w <= 128 else 8
    keys = np.full((m, 32 * per_lane), 0xFFFFFFFF, np.uint32)
    # lane l, slot s loads column l + 32 s into position l * per_lane + s
    for s in range(per_lane):
        cols = np.arange(32) + 32 * s
        keep = cols < w
        keys[:, (np.arange(32) * per_lane + s)[keep]] = _keys(x)[:, cols[keep]]
    return _floats(_warp_sort(keys, per_lane)[:, k - 1])


def kth_by_search(x, k):
    """The bitwise search: the largest ``v`` with fewer than ``k`` keys below it."""
    keys = _keys(x).astype(np.uint64)
    v = np.zeros(len(x), np.uint64)
    for bit in range(31, -1, -1):
        t = v | np.uint64(1 << bit)
        v = np.where((keys < t[:, None]).sum(axis=1) < k, t, v)
    return _floats(v)


def _middle(w):
    return max(1, (7 * w) // 10)


@pytest.mark.parametrize("width", WIDTHS)
def test_network_model_equals_plain_version_and_jax_kernel(width):
    x = _float_rows(300 + width, width, seed=width)
    for k in sorted({1, _middle(width), width}):
        want = cfar.kth_smallest_reference(torch.from_numpy(x), k).numpy()
        got = kth_by_network(x, k)
        assert (got == want).all()  # ==: -0.0 and +0.0 are one value
        np.testing.assert_array_equal(
            want, np.asarray(jax_kth_smallest(x, k, interpret=True)))
    np.testing.assert_array_equal(  # one of the inputs, bit for bit
        np.sort(_keys(kth_by_network(x, 1))), np.sort(_keys(x).min(axis=1)))


@pytest.mark.parametrize("width,k", [(33, 1), (33, 20), (64, 64), (65, 33), (128, 100),
                                     (129, 1), (220, 154), (256, 256), (256, 1)])
def test_warp_sort_and_search_models_equal_plain_version(width, k):
    x = _float_rows(40, width, seed=width + k)
    want = cfar.kth_smallest_reference(torch.from_numpy(x), k).numpy()
    assert (kth_by_warp_sort(x, k) == want).all()
    assert (kth_by_search(x, k) == want).all()
    np.testing.assert_array_equal(want, np.asarray(jax_kth_smallest(x, k, interpret=True)))


@pytest.mark.parametrize("per_lane", [2, 4, 8])
def test_warp_sort_model_sorts_any_keys(per_lane):
    """The merge's first step pairs ``i`` with ``i ^ (size - 1)``: no direction bit is needed."""
    rng = np.random.default_rng(per_lane)
    keys = rng.integers(0, 50, (200, 32 * per_lane)).astype(np.uint32)  # many ties
    keys[0] = np.arange(32 * per_lane)[::-1]
    keys[1] = 7
    np.testing.assert_array_equal(_warp_sort(keys, per_lane), np.sort(keys, axis=1))
    bits = rng.integers(0, 2, (3000, 32 * per_lane)).astype(np.uint32)
    np.testing.assert_array_equal(_warp_sort(bits, per_lane), np.sort(bits, axis=1))


@pytest.mark.parametrize("w", [24, 32, 33, 256, 257])
def test_kth_kernel_wrapper_raises_off_the_gpu_at_every_width(w):
    """Widths on both sides of 32 and 256: each kernel's range refuses a CPU tensor."""
    before = rank_select.kth_smallest.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        rank_select.kth_smallest(torch.zeros(4, w), 3)
    assert rank_select.kth_smallest.launches == before


# --------------------------------------------------------------------------- #
# the detection kernel: geometry
# --------------------------------------------------------------------------- #
FLAGSHIP = dict(num_train=(5, 5), num_guard=(3, 2))
SECOND = dict(num_train=(4, 6), num_guard=(2, 1))
ZERO_GUARD = dict(num_train=(3, 2), num_guard=(0, 0))
NARROW = dict(num_train=(2, 1), num_guard=(1, 0))
NO_SIDES = dict(num_train=(2, 0), num_guard=(1, 2))   # no training column beside the box
NO_BANDS = dict(num_train=(0, 3), num_guard=(2, 1))   # no training row above or below it
WIDE = dict(num_train=(1, 14), num_guard=(1, 3))      # a 35-column window: run-time loops

GEOMETRY_CASES = [
    (63, 70, FLAGSHIP, 1024), (63, 70, FLAGSHIP, 7), (63, 70, FLAGSHIP, 1),
    (17, 15, FLAGSHIP, 3), (18, 16, FLAGSHIP, 1), (64, 128, SECOND, 5),
    (256, 192, FLAGSHIP, 2), (256, 192, FLAGSHIP, 1024), (63, 70, ZERO_GUARD, 1),
    (63, 70, NARROW, 7), (40, 50, NO_SIDES, 1), (40, 50, NO_BANDS, 2), (30, 80, WIDE, 1),
]
GEOMETRY_IDS = [f"{r}x{c}_t{kw['num_train'][0]}-{kw['num_train'][1]}"
                f"g{kw['num_guard'][0]}-{kw['num_guard'][1]}_b{b}"
                for r, c, kw, b in GEOMETRY_CASES]


def _window(kw):
    (tr, td), (gr, gd) = kw["num_train"], kw["num_guard"]
    return 2 * (tr + gr) + 1, 2 * (td + gd) + 1


def _tiles(geo, r_out, d_out):
    for tile_row in range(geo.tiles_r):
        for tile_col in range(geo.tiles_d):
            r0, c0 = tile_row * geo.tile_r, tile_col * geo.tile_d
            yield (tile_row, tile_col, r0, c0, min(geo.tile_r, r_out - r0),
                   min(geo.tile_d, d_out - c0))


@pytest.mark.parametrize("rows,cols,kw,batch", GEOMETRY_CASES, ids=GEOMETRY_IDS)
def test_detect_tiles_cover_every_interior_cell_and_every_map_cell_once(rows, cols, kw, batch):
    geo = kernel.detect_launch_geometry(rows, cols, kw["num_train"], kw["num_guard"], batch)
    win_r, win_d = _window(kw)
    er, ed = win_r // 2, win_d // 2
    r_out, d_out = rows - win_r + 1, cols - win_d + 1
    assert geo.tiles_r == -(-r_out // geo.tile_r) and geo.tiles_d == -(-d_out // geo.tile_d)
    core = np.zeros((r_out, d_out), np.int32)
    written = np.zeros((rows, cols), np.int32)
    for tile_row, tile_col, r0, c0, cells_r, cells_d in _tiles(geo, r_out, d_out):
        assert cells_r >= 1 and cells_d >= 1, "an empty tile"
        core[r0 : r0 + cells_r, c0 : c0 + cells_d] += 1
        # the rectangle the tile writes: its cells, and the map's edge where it touches it
        top = 0 if tile_row == 0 else er + r0
        bottom = rows if tile_row == geo.tiles_r - 1 else er + r0 + cells_r
        first = 0 if tile_col == 0 else ed + c0
        last = cols if tile_col == geo.tiles_d - 1 else ed + c0 + cells_d
        written[top:bottom, first:last] += 1
    assert (core == 1).all() and (written == 1).all()


@pytest.mark.parametrize("rows,cols,kw,batch", GEOMETRY_CASES, ids=GEOMETRY_IDS)
def test_detect_region_fits_shared_memory_and_its_loads_stay_in_a_row(rows, cols, kw, batch):
    geo = kernel.detect_launch_geometry(rows, cols, kw["num_train"], kw["num_guard"], batch)
    win_r, win_d = _window(kw)
    (_, td), (_, gd) = kw["num_train"], kw["num_guard"]
    right = td + 2 * gd + 1
    assert geo.tile_d % kernel.STRIP == 0
    assert geo.region_r == geo.tile_r + win_r - 1 and geo.region_d == geo.tile_d + win_d - 1
    assert geo.stride % 4 == 0 and geo.stride >= geo.region_d + 4
    assert (geo.stride - geo.tile_d) % 32 == 0  # lanes run on into the next row's banks
    assert geo.stride < geo.region_d + 4 + 32
    assert geo.copies == (2 if right % 4 else 1)
    mask_bytes = -(-geo.tile_r * geo.tile_d // 16) * 16
    assert geo.smem_bytes == 4 * geo.copies * geo.region_r * geo.stride + mask_bytes
    assert geo.smem_bytes <= kernel.MAX_SHARED_BYTES
    if geo.tiles_r * geo.tiles_d > 1 and geo.tile_r > 1 and geo.tile_d > kernel.STRIP:
        assert geo.smem_bytes <= kernel.PREFERRED_DETECT_SHARED_BYTES
    # the last strip's 16-byte loads: the full-width run, the left and the right run
    last_strip = geo.tile_d - kernel.STRIP
    vector = lambda n: 4 * -(-(n + 3) // 4)  # noqa: E731  words read for a run of n columns
    assert last_strip + vector(win_d) <= geo.stride
    assert last_strip + vector(td) <= geo.stride
    assert last_strip + right - right % 4 + vector(td) <= geo.stride
    assert geo.row_split in (1, 2, 4, 8, 16, 32) and geo.row_split <= win_r
    assert geo.row_split == 1 or geo.row_split * geo.tile_r * geo.tile_d // 4 <= 256


def test_detect_geometry_fills_the_card_and_keeps_a_flagship_frame_whole():
    whole = kernel.detect_launch_geometry(63, 70, (5, 5), (3, 2), 1024)
    assert (whole.tiles_r, whole.tiles_d, whole.tile_r, whole.tile_d) == (1, 1, 47, 56)
    assert whole.smem_bytes <= 48 * 1024 and whole.row_split == 1
    for batch in (1, 7, 64):
        geo = kernel.detect_launch_geometry(63, 70, (5, 5), (3, 2), batch)
        assert batch * geo.tiles_r * geo.tiles_d >= 132 or geo.tile_r * geo.tile_d <= 64
    one = kernel.detect_launch_geometry(63, 70, (5, 5), (3, 2), 1, whole_frame=True)
    assert one[:8] == whole[:8]
    assert kernel.frame_fits_one_block(63, 70, (5, 5), (3, 2))
    assert kernel.frame_fits_one_block(128, 128, (5, 5), (3, 2))
    assert not kernel.frame_fits_one_block(256, 192, (5, 5), (3, 2))
    assert not kernel.frame_fits_one_block(10, 12, (5, 5), (3, 2))  # no interior cell


@pytest.mark.parametrize("rows,cols,kw,match", [
    (16, 15, FLAGSHIP, "smaller than"), (17, 14, FLAGSHIP, "smaller than"),
    (400, 400, dict(num_train=(150, 150), num_guard=(4, 4)), "shared memory"),
])
def test_detect_geometry_rejects_what_the_kernel_does_not_take(rows, cols, kw, match):
    with pytest.raises(ValueError, match=match):
        kernel.detect_launch_geometry(rows, cols, kw["num_train"], kw["num_guard"], 1)


# --------------------------------------------------------------------------- #
# the detection kernel: a numpy model of its algorithm
# --------------------------------------------------------------------------- #
def _count_run(row, start, length, cuts, vector):
    """Counts of ``row[start + q : start + q + length] < cuts[q]`` for a strip's 4 cells.

    ``vector``: the kernel's 16-byte loads, whole vectors from an aligned start.
    """
    if length == 0:
        return np.zeros(4, np.int64)
    if vector:
        assert start % 4 == 0
        values = row[start : start + 4 * -(-(length + 3) // 4)]
        assert len(values) == 4 * -(-(length + 3) // 4), "a load past the row's end"
    else:
        values = row[start : start + length + 3]
    return np.array([(values[q : q + length] < cuts[q]).sum() for q in range(4)])


def detect_by_strips(x, *, num_train, num_guard, k, alpha, batch_for_geometry=None,
                     whole_frame=False):
    """The kernel's algorithm in numpy, with its launch geometry, on ``[B, R, D]`` float32."""
    b, rows, cols = x.shape
    (tr, td), (gr, gd) = num_train, num_guard
    geo = kernel.detect_launch_geometry(rows, cols, num_train, num_guard,
                                        batch_for_geometry or b, whole_frame)
    win_r, win_d = _window(dict(num_train=num_train, num_guard=num_guard))
    er, ed = tr + gr, td + gd
    r_out, d_out = rows - 2 * er, cols - 2 * ed
    right, guard_rows = td + 2 * gd + 1, 2 * gr + 1
    shift = right % 4
    vector = max(win_d, td) <= 31
    out = np.zeros(x.shape, bool)
    for frame in range(b):
        for _, _, r0, c0, cells_r, cells_d in _tiles(geo, r_out, d_out):
            reg_r = cells_r + win_r - 1
            scaled = np.zeros((reg_r, geo.stride), np.float32)
            width = min(geo.stride, cols - c0)
            # the float32 product, rounded once
            scaled[:, :width] = np.float32(alpha) * x[frame, r0 : r0 + reg_r, c0 : c0 + width]
            shifted = np.zeros_like(scaled)
            shifted[:, : geo.stride - shift] = scaled[:, shift:]
            for r in range(cells_r):
                for strip in range(-(-cells_d // 4)):
                    cuts = np.zeros(4, np.float32)
                    live = min(4, cells_d - 4 * strip)
                    cuts[:live] = x[frame, r0 + er + r, c0 + ed + 4 * strip :][:live]
                    counts = np.zeros(4, np.int64)
                    for lane in range(geo.row_split):  # each lane's share, then the shuffle sum
                        for j in range(lane, 2 * tr, geo.row_split):
                            row = j if j < tr else j + guard_rows
                            counts += _count_run(scaled[r + row], 4 * strip, win_d, cuts, vector)
                        for i in range(tr + lane, tr + 2 * gr + 1, geo.row_split):
                            counts += _count_run(scaled[r + i], 4 * strip, td, cuts, vector)
                            counts += _count_run(shifted[r + i], 4 * strip + right - shift, td,
                                                 cuts, vector)
                    out[frame, r0 + er + r, c0 + ed + 4 * strip :][:live] = counts[:live] >= k
    return out


def _maps(shape, seed):
    """Quantized exponential maps (ties across a window), some ``+inf`` and zeros."""
    rng = np.random.default_rng(seed)
    x = (np.round(rng.exponential(1.0, shape) * 8) / 8).astype(np.float32)
    x[..., ::9, ::7] = np.inf
    x[..., 1::7, 3::5] = 0.0
    return x


MODEL_CASES = [((2, 30, 33), FLAGSHIP, 0.7, 4.0, 1024), ((1, 30, 33), FLAGSHIP, 0.7, 4.0, 1),
               ((16, 17, 15), FLAGSHIP, 0.3, 1.0, 16), ((1, 18, 19), FLAGSHIP, 0.3, 1.5, 1),
               ((2, 30, 40), SECOND, 0.5, 3.0, 2), ((1, 24, 22), ZERO_GUARD, 0.5, 2.0, 1),
               ((1, 24, 22), NARROW, 0.6, 2.0, 64), ((1, 20, 24), NO_SIDES, 0.5, 1.5, 1),
               ((2, 20, 24), NO_BANDS, 0.5, 1.5, 2), ((1, 12, 60), WIDE, 0.5, 2.0, 1)]
MODEL_IDS = ["flagship_whole", "flagship_tiled", "one_window", "a_cell_more", "second",
             "zero_guard", "narrow", "no_side_columns", "no_rows_above", "wide_runtime_loops"]


@pytest.mark.parametrize("shape,kw,rho,alpha,batch", MODEL_CASES, ids=MODEL_IDS)
def test_strip_model_equals_plain_version_and_jax(shape, kw, rho, alpha, batch):
    x = _maps(shape, seed=shape[1] + shape[2])
    k = cfar._geometry(kw["num_train"], kw["num_guard"], rho)[3]
    got = detect_by_strips(x, k=k, alpha=alpha, batch_for_geometry=batch, **kw)
    want = cfar.os_2d_detect_reference(torch.from_numpy(x), rho=rho, alpha=alpha, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(
        want, np.asarray(jcfar.os_2d_detect(x, rho=rho, alpha=alpha, method="xla", **kw)))


def compact_by_chunks(mask, capacity, edges, threads=256):
    """The compacting epilogue in numpy: a chunk of consecutive interior cells a thread."""
    b, rows, cols = mask.shape
    er, ed = edges
    inner = mask[:, er : rows - er, ed : cols - ed].reshape(b, -1)
    d_out = cols - 2 * ed
    n = inner.shape[1]
    chunk = -(-n // threads)
    out_r = np.full((b, capacity), -1, np.int64)
    out_c = np.full((b, capacity), -1, np.int64)
    valid = np.full((b, capacity), -1, np.int8)
    count = np.empty(b, np.int32)
    for f in range(b):
        begins = [min(n, t * chunk) for t in range(threads)]
        mine = [int(inner[f, s : min(n, s + chunk)].sum()) for s in begins]
        offsets = np.concatenate([[0], np.cumsum(mine)[:-1]])  # the block's exclusive scan
        total = sum(mine)
        for begin, offset in zip(begins, offsets):
            for i in range(begin, min(n, begin + chunk)):
                if inner[f, i]:
                    if offset < capacity:
                        assert valid[f, offset] == -1, "a slot written twice"
                        out_r[f, offset], out_c[f, offset] = er + i // d_out, ed + i % d_out
                        valid[f, offset] = 1
                    offset += 1
        for slot in range(total, capacity):
            assert valid[f, slot] == -1, "a slot written twice"
            out_r[f, slot] = out_c[f, slot] = valid[f, slot] = 0
        count[f] = min(total, capacity)
    assert (valid >= 0).all(), "a slot never written"
    return out_r, out_c, valid.astype(bool), count


@pytest.mark.parametrize("capacity", [1, 16, 128, 700])
def test_compaction_model_equals_mask_to_indices_2d(capacity):
    rng = np.random.default_rng(capacity)
    mask = np.zeros((5, 30, 33), bool)
    density = (0.0, 0.004, 16 / (14 * 19), 0.3, 1.0)  # none, few, about 16, many, all
    for f, p in enumerate(density):
        mask[f, 8:22, 7:26] = rng.random((14, 19)) < p
    exactly = np.zeros(14 * 19, bool)
    exactly[rng.permutation(14 * 19)[:16]] = True  # exactly 16
    mask[2, 8:22, 7:26] = exactly.reshape(14, 19)
    got = compact_by_chunks(mask, capacity, (8, 7))
    want = masked.mask_to_indices_2d(torch.from_numpy(mask), capacity, interior=(8, 7))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert int(want[3][2]) == min(16, capacity)


COMPACT_CASES = [((3, 30, 33), FLAGSHIP, 0.7, 4.0, 128), ((3, 30, 33), FLAGSHIP, 0.3, 1.2, 8),
                 ((2, 24, 40), SECOND, 0.5, 3.0, 16), ((2, 2, 17, 15), FLAGSHIP, 0.5, 1.0, 4),
                 ((2, 10, 12), FLAGSHIP, 0.7, 4.0, 5), ((30, 33), ZERO_GUARD, 0.5, 2.0, 2000)]


@pytest.mark.parametrize("shape,kw,rho,alpha,capacity", COMPACT_CASES,
                         ids=["flagship", "over_capacity", "second", "two_lead_dims",
                              "smaller_than_a_window", "capacity_over_the_map"])
def test_os_2d_detect_compact_on_the_cpu_equals_jax(shape, kw, rho, alpha, capacity):
    x = _maps(shape, seed=sum(shape))
    got = cfar.os_2d_detect_compact(torch.from_numpy(x), capacity, rho=rho, alpha=alpha, **kw)
    det = jcfar.os_2d_detect(x, rho=rho, alpha=alpha, method="xla", **kw)
    compact = lambda m: jmasked.mask_to_indices_2d(m, capacity)  # noqa: E731
    for _ in shape[:-2]:
        compact = jax.vmap(compact)
    want = compact(det)
    for g, w, dtype in zip(got, want, (torch.int64, torch.int64, torch.bool, torch.int32)):
        assert g.dtype == dtype and tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # its plain version: the plain mask, then mask_to_indices_2d
    plain = masked.mask_to_indices_2d(
        cfar.os_2d_detect_reference(torch.from_numpy(x), rho=rho, alpha=alpha, **kw), capacity)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)
    if capacity == 8:
        assert int(got[3].max()) == capacity < int(np.asarray(det).sum(axis=(-2, -1)).max())


def test_compact_launch_on_the_cpu_raises_and_never_counts():
    x = torch.from_numpy(_maps((2, 30, 33), seed=1))
    before = kernel.os_cfar_2d_detect.launches
    cfar.os_2d_detect_compact(x, 16, rho=0.7, alpha=4.0, **FLAGSHIP)
    cfar.os_2d_detect(x, rho=0.7, alpha=4.0, **FLAGSHIP)
    assert kernel.os_cfar_2d_detect.launches == before
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernel.os_cfar_2d_detect_compact(x, 16, k=100, alpha=4.0, **FLAGSHIP)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernel.os_cfar_2d_detect(x, k=100, alpha=4.0, **FLAGSHIP)
