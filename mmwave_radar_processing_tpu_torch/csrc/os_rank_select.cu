// Rank selection for OS-CFAR on Hopper (sm_90a): the k-th smallest of a set of
// float32 values, exact.  Two entry points.
//
//   os_cfar_2d_noise  replaces the TPU kernel
//     mmwave_radar_processing_tpu/ops/pallas/os_cfar.py :: os_cfar_2d_noise_fused
//     for every core cell of a [B, R, D] map, the k-th smallest (1-based) of
//     its training cells: the (2(tr+gr)+1) x (2(td+gd)+1) window less the
//     guard box (which holds the cell under test).  Output [B, R-2er, D-2ed].
//   kth_smallest      replaces the TPU kernel
//     mmwave_radar_processing_tpu/ops/pallas/rank_select.py :: kth_smallest
//     the k-th smallest (1-based) along the last axis of [M, W].
//
// Selection in the noise map, and in kth_smallest above 256 columns: a bitwise
// search.  key(x), the order-preserving integer image of the float, flips the sign bit of a non-negative float and all bits of a
// negative one, so unsigned key order is float order.  The k-th smallest of a
// set of integers is the largest v with #{element < v} <= k-1; v is built from
// the top bit down, one counting pass over the set per bit.  The result is one
// of the inputs, bit for bit, so it equals sort(values)[k-1] under == (-0.0
// and +0.0 have different keys but compare equal).  +inf sorts last.  NaNs are
// not engineered: one with the sign bit clear sorts after +inf, as torch.sort
// places it; one with the sign bit set sorts before -inf, where torch.sort
// would place it last.
//
// Neither design carries over the TPU kernels' layout (windows padded to 256
// slots with +inf, a full bitonic network over a [256, R', D'] scratch of every
// window, rows padded to 128 lanes and tiles of 256): nothing is padded in
// device memory and no window is ever sorted.
//
// os_cfar_2d_noise.  What bounds it on this card: a flagship frame ([63, 70],
// a 17 x 15 window less a 7 x 5 guard box, 220 training cells, k = 154) moves
// 17.6 KB in and 10.5 KB out, and a selection needs about n + min(k, n-k) = 286
// compares a cell: 11.5 us for 1024 frames.  No search comes near that; what
// the kernel spends is counting passes over the window, so the design cuts the
// passes, the loads and the instructions of a pass:
//   1. Ranks, not floats.  A block takes a tile of core cells (a whole
//      flagship frame; tiles of at most 8,192 region values on larger maps and,
//      at a small batch, tiles down to 64 cells so that the card fills), sorts
//      the tile's region (its cells and their windows) once and replaces every
//      value by its rank, the number of keys below it.  The k-th smallest rank
//      of a window belongs to the k-th smallest value, which is read back from
//      the sorted keys.  A search over ranks takes ceil(log2 region) passes,
//      whatever the data: 13 for a flagship frame where the search over float
//      keys took 32.
//   2. The sort is a bitonic network with sort_size / 256 keys a thread held in
//      registers: a step stays inside the thread, crosses lanes by shuffle or,
//      for the 6 widest of 91 steps at 8,192 keys, crosses warps through shared
//      memory.  Ranks come from a bisection of the sorted keys (ties share the
//      lower bound, which the search handles).
//   3. Ranks are kept as 16-bit patterns of a half (rank + 0x0400: positive
//      normal halves order as their bits), two to a word, in two copies, the
//      second shifted by a column, so that a run starting at any column starts
//      on a word.  __hlt2_mask compares two ranks in one instruction and the
//      masks are summed as integers, two to an add (see MaskSum): 1.5
//      instructions for two training cells.
//   4. A thread selects for a strip of 4 neighbouring cells: cells q and q + 2
//      read the same copy one word apart, so each word is loaded once for both;
//      threads of a warp sit on neighbouring rows, whose words fall on
//      different banks (an odd row length).  A window has runs of two lengths
//      (its whole width above and below the guard box, its training columns
//      beside it); each pass finds the instance of its loops that has the
//      length as a compile-time constant (up to 31 columns; a bisection, 5
//      uniform branches), so the runs unroll into straight-line code.
//   5. At a small batch the window rows of a strip are split over 2 to 32 lanes
//      whose counts are summed by shuffle, so that one frame still gives every
//      SM work: 42 blocks of 8 x 8 cells, 16 lanes a strip.
// Times (NVIDIA H100 80GB HBM3, 700.00 W; [1024, 63, 70], k = 154, in turns
// with the earlier kernel in one job): the 32-pass search over float keys, one
// block a frame, 5.95 ms; ranks with a bitonic network in shared memory and
// half2 compare-adds 1.52 ms; summed masks 1.41; the sort in registers, the
// runs still run-time loops, 1.16 at a 17 x 15 window of 206 training cells;
// run lengths as compile-time constants 0.81 there, 0.88 at the flagship's 220
// cells and 0.73 at a 13 x 15 window of 180.  An instance with the flagship's
// columns (5 training, 2 guard) as template parameters took 0.85 there: 3% for
// one window, not kept.  The rows above and below the guard box shared out
// over a strip's lanes as one band: one frame 24 -> 22 us of device time
// (0.178 ms before the redesign), 0.89 / 0.84 / 0.74 at 1024 frames, the same
// on quantized and on continuous maps.  What is left: the counting passes take
// about two thirds, near the SM's instruction rate; the sort and the ranks
// take the rest.
//
// kth_smallest.  Bound: [M, W] moves 4*M*(W+1) bytes, and a selection needs
// about W + min(k, W-k) compares a row: bytes.  Three forms, by the width
// (nothing is padded in memory in any of them):
//   W <= 32: a thread a row.  The row's keys sit in W registers and a sorting
//     network orders them: Batcher's odd-even merge sort of the next power of
//     two, less every compare-exchange that touches a pad (pads are the
//     largest key and sit at the top, so those change nothing): 132 at W = 24,
//     191 at 32, each an unsigned min and max, exact on ties and zeros.  The
//     list is generated at build time (ops/kernels/sorting_network.py), with
//     literal indices.  k is a run-time argument: register k-1 comes out of a
//     tree of bitwise selects, never a run-time register index.  The block's
//     rows are staged through shared memory with coalesced loads.
//   32 < W <= 256: a warp a row, 2, 4 or 8 keys a lane, a bitonic network
//     whose steps stay in the thread below the lane's keys and cross lanes by
//     shuffle above; position k-1 is then one shuffle away.
//   W > 256: the bitwise search of the header above, 32 lanes a row, each
//     pass re-reading the row (it stays in L1).  Up to 256 columns the same
//     search with the keys once in 8 registers a lane was the only form before
//     ("the search" in the times below).
// Times (NVIDIA H100 80GB HBM3, 700.00 W, in turns in one job).  [2451456, 24],
// k = 12: the search 0.527-0.553 ms; the network with a thread reading its own
// row as 16-byte vectors 0.229-0.236 (the compiler kept part of the keys in
// local memory there); staged through shared memory 0.165, kept; the bytes
// need 0.073.  [168448, 220], k = 154: the search 0.389-0.396; starting it
// below the bits that all keys of a warp's rows share (a minimum and a maximum
// by shuffle first) 0.445-0.452 on exponential rows and on rows with a
// denormal and +inf alike: slower, dropped; the warp-wide sort 0.166-0.168,
// kept.  On the same 148 MB cut to other widths the kept forms took 0.37 (W =
// 8) to 0.53 (W = 32) and 0.43 (W = 129) to 0.51 (W = 33) of the search's time.
//
// Built by nvcc into a shared library with plain C entry points, loaded with
// ctypes (mmwave_radar_processing_tpu_torch/ops/kernels/_build.py).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_helpers.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t float_to_key(float x) {
  const uint32_t bits = __float_as_uint(x);
  return bits ^ ((bits & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float key_to_float(uint32_t key) {
  return __uint_as_float(key ^ ((key & 0x80000000u) ? 0x80000000u : 0xFFFFFFFFu));
}

// The k-th smallest key (1-based) of a set given by `count_below(t)`, the
// number of its keys strictly below t: the largest v with count_below(v) < k.
template <class CountBelow>
__device__ __forceinline__ uint32_t kth_smallest_key(int k, CountBelow count_below) {
  uint32_t v = 0;
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t t = v | (1u << bit);
    if (count_below(t) < k) v = t;
  }
  return v;
}

// The launch geometry of the noise map, computed on the host
// (ops/kernels/os_cfar.py :: noise_launch_geometry).
struct NoiseLaunch {
  int rows, cols, tr, td, gr, gd, k;
  int tile_r, tile_d, tiles_r, tiles_d;  // core cells a tile (tile_d: 4 divides it), tiles a frame
  int words_per_row;                     // of a rank copy, odd: rows fall on different banks
  int sort_size, passes, row_split;
};

constexpr unsigned short kRankBase = 0x0400;  // rank 0 as a half: the smallest normal
constexpr unsigned short kRankPad = 0x7BFF;   // the largest finite half

// A lane's count of ranks below a threshold.  __hlt2_mask gives 0xFFFF for each
// half of a word that is below; the masks are summed as plain 32-bit integers,
// two to an add: with L low halves and H high halves below, the sum is
// 65535*L - 65536*H (mod 2^32), from which both come back as long as each
// stays under 65536.
struct MaskSum {
  uint32_t sum = 0;
  __device__ __forceinline__ void add(uint32_t m0, uint32_t m1) { sum += m0 + m1; }
  __device__ __forceinline__ void add(uint32_t m) { sum += m; }
  __device__ __forceinline__ int count() const {
    const uint32_t low = (0u - sum) & 0xFFFFu;
    const uint32_t high = ((low << 16) - low - sum) >> 16;
    return static_cast<int>(low + high);
  }
};

// Count, for the strip's cells q and q + 2, the ranks below their thresholds
// in `len` columns starting at the word `wp` (cell q + 2 starts one word on).
// Full words first, then the low lane of one more word if `len` is odd.
__device__ __forceinline__ void count_pair(const __half2* __restrict__ wp, int len,
                                           __half2 t0, __half2 t0_low, __half2 t2,
                                           __half2 t2_low, MaskSum& a0, MaskSum& a2) {
  const int full = len >> 1;
  const bool odd = len & 1;
  if (full > 0) {
    // cell q takes words [0, full), cell q + 2 words [1, full]
    __half2 w = wp[0];
    int i = 1;
#pragma unroll
    for (; i + 1 < full; i += 2) {
      const __half2 w1 = wp[i], w2 = wp[i + 1];
      a0.add(__hlt2_mask(w, t0), __hlt2_mask(w1, t0));
      a2.add(__hlt2_mask(w1, t2), __hlt2_mask(w2, t2));
      w = w2;
    }
    if (i < full) {
      const __half2 w1 = wp[i];
      a0.add(__hlt2_mask(w, t0), __hlt2_mask(w1, t0));
      a2.add(__hlt2_mask(w1, t2));
    } else {
      a0.add(__hlt2_mask(w, t0));
    }
    w = wp[full];
    if (odd) {
      a0.add(__hlt2_mask(w, t0_low));
      a2.add(__hlt2_mask(w, t2), __hlt2_mask(wp[full + 1], t2_low));
    } else {
      a2.add(__hlt2_mask(w, t2));
    }
  } else if (odd) {
    a0.add(__hlt2_mask(wp[0], t0_low));
    a2.add(__hlt2_mask(wp[1], t2_low));
  }
}

// The sorted keys sit in shared memory with one word of padding after every
// 32, so that a thread's run of consecutive keys falls on different banks.
__device__ __forceinline__ int sorted_slot(int pos) { return pos + (pos >> 5); }

// One compare-exchange step inside a thread, at the compile-time distance kJ.
template <int kE, int kJ>
__device__ __forceinline__ void exchange_in_thread(uint32_t (&key)[kE], int first, int size) {
#pragma unroll
  for (int s = 0; s < kE; ++s) {
    if ((s & kJ) == 0) {
      const uint32_t lo = min(key[s], key[s | kJ]), hi = max(key[s], key[s | kJ]);
      const bool up = ((first + s) & size) == 0;
      key[s] = up ? lo : hi;
      key[s | kJ] = up ? hi : lo;
    }
  }
}

// The in-thread step at run-time distance j: one of kJ, kJ/2, ..., 1.
template <int kE, int kJ>
__device__ __forceinline__ void exchange_at(uint32_t (&key)[kE], int first, int size, int j) {
  if constexpr (kJ > 0) {
    if (j == kJ) {
      exchange_in_thread<kE, kJ>(key, first, size);
    } else {
      exchange_at<kE, kJ / 2>(key, first, size, j);
    }
  }
}

// A bitonic network over kE * kThreads keys, ascending; thread t holds keys
// [t*kE, (t+1)*kE) in registers throughout.  A step at distance j stays inside
// the thread for j < kE, crosses lanes by shuffle for j < 32*kE, and crosses
// warps through shared memory (slot-major, no bank conflicts) above that: 6 of
// the 91 steps at kE = 32.  In: buf[sorted_slot(i)] = key i, synchronised.
// Out: the same, sorted and synchronised.
template <int kE>
__device__ __forceinline__ void block_sort(uint32_t* buf) {
  const int tid = threadIdx.x, first = tid * kE;
  uint32_t key[kE];
#pragma unroll
  for (int s = 0; s < kE; ++s) key[s] = buf[sorted_slot(first + s)];
  __syncthreads();
#pragma unroll 1
  for (int size = 2; size <= kE * kThreads; size <<= 1) {
#pragma unroll 1
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j < kE) {
        exchange_at<kE, kE / 2>(key, first, size, j);
      } else {
        const int mask = j / kE;  // the partner thread is tid ^ mask
        const bool lower = (tid & mask) == 0;
        const bool through_shared = mask >= 32;
        if (through_shared) {
#pragma unroll
          for (int s = 0; s < kE; ++s) buf[s * kThreads + tid] = key[s];
          __syncthreads();
        }
#pragma unroll
        for (int s = 0; s < kE; ++s) {
          uint32_t other;
          if (through_shared) {
            other = buf[s * kThreads + (tid ^ mask)];
          } else {
            other = __shfl_xor_sync(0xFFFFFFFFu, key[s], mask);
          }
          const bool up = ((first + s) & size) == 0;
          key[s] = lower == up ? min(key[s], other) : max(key[s], other);
        }
        if (through_shared) __syncthreads();
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kE; ++s) buf[sorted_slot(first + s)] = key[s];
  __syncthreads();
}

// kBig: the instance for a region of 16,384 values, 64 keys a thread in the
// sort; the other keeps at most 32 and fits 4 blocks of 64 registers a thread
// on an SM.
template <bool kBig>
__global__ void __launch_bounds__(kThreads, kBig ? 1 : 4)
os_cfar_2d_noise_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const NoiseLaunch p) {
  extern __shared__ uint32_t smem[];
  const int td = p.td, gd = p.gd;
  const int win_r = 2 * (p.tr + p.gr) + 1, win_d = 2 * (td + gd) + 1;
  const int r_out = p.rows - win_r + 1, d_out = p.cols - win_d + 1;
  const int gr1 = p.tr + 2 * p.gr, gd1 = td + 2 * gd;  // guard box: [tr, gr1] x [td, gd1]
  const int tiles = p.tiles_r * p.tiles_d;
  const int tile = blockIdx.x % tiles;
  const size_t frame = blockIdx.x / tiles;
  const int r0 = (tile / p.tiles_d) * p.tile_r, c0 = (tile % p.tiles_d) * p.tile_d;
  const int cells_r = min(p.tile_r, r_out - r0), cells_d = min(p.tile_d, d_out - c0);
  // the region: the tile's cells and their windows; columns past the map are padding
  const int reg_r = cells_r + win_r - 1, reg_d = p.tile_d + win_d - 1;
  const int n_reg = reg_r * reg_d;
  const int slots = 2 * p.words_per_row;  // 16-bit slots a row of a copy

  uint32_t* sorted = smem;  // [sort_size + sort_size / 32], see sorted_slot
  unsigned short* copy_a =
      reinterpret_cast<unsigned short*>(smem + p.sort_size + (p.sort_size >> 5));
  unsigned short* copy_b = copy_a + static_cast<size_t>(p.tile_r + win_r - 1) * slots;
  const float* xb = x + frame * p.rows * p.cols + static_cast<size_t>(r0) * p.cols + c0;

  auto region_key = [&](int rr, int cc) {
    return c0 + cc < p.cols ? float_to_key(xb[rr * p.cols + cc]) : 0xFFFFFFFFu;
  };

  // 1. the region's keys, padded to the sort's size with the largest key
  for (int i = threadIdx.x; i < p.sort_size; i += kThreads) {
    uint32_t key = 0xFFFFFFFFu;
    if (i < n_reg) {
      const int rr = i / reg_d;
      key = region_key(rr, i - rr * reg_d);
    }
    sorted[sorted_slot(i)] = key;
  }
  __syncthreads();

  // 2. sort them: sort_size / kThreads keys a thread
  switch (p.sort_size / kThreads) {
    case 1: block_sort<1>(sorted); break;
    case 2: block_sort<2>(sorted); break;
    case 4: block_sort<4>(sorted); break;
    case 8: block_sort<8>(sorted); break;
    case 16: block_sort<16>(sorted); break;
    case 32: block_sort<32>(sorted); break;
    default:
      if constexpr (kBig) block_sort<64>(sorted);
      break;
  }

  // 3. every value's rank (the number of keys below it), as the bits of a
  //    half, in two copies: word j of copy A holds columns (2j, 2j+1), of
  //    copy B columns (2j+1, 2j+2), so a run from any column starts on a word
  for (int i = threadIdx.x; i < reg_r * slots; i += kThreads) {
    const int rr = i / slots, cc = i - rr * slots;
    unsigned short val = kRankPad;
    if (cc < reg_d) {
      const uint32_t key = region_key(rr, cc);
      int pos = 0;
      for (int step = p.sort_size >> 1; step > 0; step >>= 1) {
        if (sorted[sorted_slot(pos + step - 1)] < key) pos += step;
      }
      val = static_cast<unsigned short>(pos + kRankBase);
    }
    copy_a[i] = val;
    if (cc > 0) copy_b[i - 1] = val;
    if (cc == slots - 1) copy_b[i] = kRankPad;
  }
  __syncthreads();

  // 4. the k-th smallest rank of every window by a bitwise search, `passes`
  //    counting passes; a group of `row_split` lanes shares a strip of 4 cells
  const __half2* words_a = reinterpret_cast<const __half2*>(copy_a);
  const __half2* words_b = reinterpret_cast<const __half2*>(copy_b);
  const int strips = (cells_d + 3) >> 2;
  const int groups = cells_r * strips;
  const int split = p.row_split, lane = threadIdx.x % split;
  const int groups_a_round = kThreads / split;
  float* ob = out + frame * r_out * d_out;
  const __half zero = __ushort_as_half(0);
  const int guard_rows = 2 * p.gr + 1;
  const int right = gd1 + 1;  // the first column after the guard box

  for (int g0 = threadIdx.x / split; g0 - threadIdx.x / split < groups;
       g0 += groups_a_round) {
    // lanes past the last strip stay for the shuffles: they redo strip 0, store nothing
    const bool live = g0 < groups;
    const int g = live ? g0 : 0;
    const int r = g % cells_r, strip = g / cells_r;
    const int base = r * p.words_per_row + 2 * strip;
    // where the runs left and right of the guard box start in row 0: cells 0
    // and 2 of the strip read the copy that has the run's first column in the
    // low half of a word, cells 1 and 3 the other copy
    const __half2* left_even = words_a + base;
    const __half2* left_odd = words_b + base;
    const __half2* right_even = ((right & 1) ? words_b : words_a) + base + (right >> 1);
    const __half2* right_odd = ((right & 1) ? words_a : words_b) + base + ((right + 1) >> 1);
    int v[4] = {0, 0, 0, 0};
#pragma unroll 1
    for (int bit = p.passes - 1; bit >= 0; --bit) {
      __half2 t[4], t_low[4];
      MaskSum acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __half h = __ushort_as_half(
            static_cast<unsigned short>((v[q] | (1 << bit)) + kRankBase));
        t[q] = __halves2half2(h, h);
        t_low[q] = __halves2half2(h, zero);
      }
      // `len` columns of window row `row` for each cell of the strip
      auto run = [&](const __half2* even, const __half2* odd, int row, int len) {
        const int off = row * p.words_per_row;
        count_pair(even + off, len, t[0], t_low[0], t[2], t_low[2], acc[0], acc[2]);
        count_pair(odd + off, len, t[1], t_low[1], t[3], t_low[3], acc[1], acc[3]);
      };
      // the 2*tr rows above and below the guard box: the window's whole width;
      // the group's lanes share them out, and then the rows through the box
      with_run_length(win_d, [&](auto len) {
        for (int j = lane; j < 2 * p.tr; j += split) {
          run(left_even, left_odd, j < p.tr ? j : j + guard_rows, len);
        }
      });
      // rows through the guard box: the training columns on either side
      with_run_length(td, [&](auto len) {
        for (int i = p.tr + lane; i <= gr1; i += split) {
          run(left_even, left_odd, i, len);
          run(right_even, right_odd, i, len);
        }
      });
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int count = acc[q].count();
        for (int o = split >> 1; o > 0; o >>= 1)
          count += __shfl_xor_sync(0xFFFFFFFFu, count, o);
        if (count < p.k) v[q] |= 1 << bit;
      }
    }
    if (live && lane == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * strip + q;
        if (c < cells_d) {
          ob[static_cast<size_t>(r0 + r) * d_out + c0 + c] =
              key_to_float(sorted[sorted_slot(v[q])]);
        }
      }
    }
  }
}

// The search, for rows wider than 256 columns: a warp a row, each pass
// re-reading the row (it stays in L1).
__global__ void __launch_bounds__(kThreads)
kth_search_kernel(const float* __restrict__ x, float* __restrict__ out, long long m, int w,
                  int k) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // warps past the last row stay for the shuffles: they redo row 0, store nothing
  const bool live = row < m;
  const float* xr = x + (live ? row : 0) * w;
  const uint32_t key = kth_smallest_key(k, [&](uint32_t t) {
    int count = 0;
    for (int j = lane; j < w; j += 32) count += float_to_key(xr[j]) < t ? 1 : 0;
    for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(0xFFFFFFFFu, count, o);
    return count;
  });
  if (live && lane == 0) out[row] = key_to_float(key);
}

// --- rows of up to 32 columns: a sorting network in registers, a thread a row ---

#define KTH_CE(i, j)                                      \
  {                                                       \
    const uint32_t lo_ = min(key[i], key[j]);             \
    key[j] = max(key[i], key[j]);                         \
    key[i] = lo_;                                         \
  }
// kth_sort_network<W>(key): generated at build time from
// ops/kernels/sorting_network.py (Batcher's odd-even merge sort, pruned of the
// compare-exchanges that touch a pad), every index a literal
#include "kth_network.h"
#undef KTH_CE

// key[idx], idx < kN at run time, without a run-time register index (which
// would put the keys in local memory): a tree of selects on the bits of idx,
// each written as bit logic (one LOP3) so that the compiler cannot turn the
// choice between two neighbours back into an indexed load.
template <int kN>
__device__ __forceinline__ uint32_t select_register(const uint32_t (&key)[kN], int idx) {
  constexpr int kBits = kN <= 1 ? 0 : kN <= 2 ? 1 : kN <= 4 ? 2 : kN <= 8 ? 3 : kN <= 16 ? 4 : 5;
  constexpr int kPadded = 1 << kBits;
  static_assert(kN <= 32, "at most 32 registers");
  uint32_t t[kPadded];
#pragma unroll
  for (int i = 0; i < kPadded; ++i) t[i] = key[i < kN ? i : kN - 1];
#pragma unroll
  for (int bit = 0; bit < kBits; ++bit) {
    const uint32_t odd = 0u - ((static_cast<uint32_t>(idx) >> bit) & 1u);  // all ones or none
#pragma unroll
    for (int i = 0; i < (kPadded >> (bit + 1)); ++i)
      t[i] = t[2 * i] ^ ((t[2 * i] ^ t[2 * i + 1]) & odd);
  }
  return t[0];
}

// A thread a row of kW columns.  The block's rows go through shared memory:
// coalesced loads, an odd row stride so that the threads' reads fall on
// different banks.  (A thread reading its own row as 16-byte vectors, rows 4*kW
// bytes apart across a warp, took 1.4 times as long at kW = 24.)
template <int kW>
__global__ void __launch_bounds__(kThreads)
kth_network_kernel(const float* __restrict__ x, float* __restrict__ out, long long m, int k) {
  constexpr int kStride = kW | 1;
  __shared__ float staged[kThreads * kStride];
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long row = row0 + threadIdx.x;
  const long long rows_here = m - row0 < kThreads ? m - row0 : kThreads;
  const int values = static_cast<int>(rows_here) * kW;
  const float* xb = x + row0 * kW;
  for (int i = threadIdx.x; i < values; i += kThreads) {
    const int r = i / kW;
    staged[r * kStride + (i - r * kW)] = xb[i];
  }
  __syncthreads();
  // a thread past the last row sorts what the memory holds and stores nothing
  uint32_t key[kW];
#pragma unroll
  for (int c = 0; c < kW; ++c) key[c] = float_to_key(staged[threadIdx.x * kStride + c]);
  kth_sort_network<kW>(key);
  const uint32_t chosen = select_register<kW>(key, k - 1);
  if (row < m) out[row] = key_to_float(chosen);
}

// --- rows of 33 to 256 columns: a warp sorts a row, kE = 2, 4 or 8 keys a lane ---

// A bitonic network over 32 * kE keys, ascending; lane l holds positions
// [l*kE, (l+1)*kE).  The first step of a merge pairs position i with
// i ^ (size - 1), the later steps with i ^ j, so every compare-exchange leaves
// the smaller key at the lower position and no direction bit is needed.
// A step stays inside the thread for a distance below kE and crosses lanes by
// shuffle above: 15 of 36 steps at kE = 8.
template <int kE>
__device__ __forceinline__ void warp_sort(uint32_t (&key)[kE], int lane) {
  constexpr int kLog = kE == 2 ? 6 : kE == 4 ? 7 : 8;  // log2(32 * kE)
  static_assert(kE == 2 || kE == 4 || kE == 8, "2, 4 or 8 keys a lane");
#pragma unroll
  for (int log_size = 1; log_size <= kLog; ++log_size) {
    const int size = 1 << log_size;
    if (size <= kE) {
#pragma unroll
      for (int s = 0; s < kE; ++s) {
        const int partner = s ^ (size - 1);
        if (s < partner) {
          const uint32_t lo = min(key[s], key[partner]);
          key[partner] = max(key[s], key[partner]);
          key[s] = lo;
        }
      }
    } else {
      // position i ^ (size - 1): slot kE - 1 - s of lane ^ (size / kE - 1)
      const int lanes = size / kE;
      const bool lower = (lane & (lanes >> 1)) == 0;
      uint32_t other[kE];
#pragma unroll
      for (int s = 0; s < kE; ++s)
        other[s] = __shfl_xor_sync(0xFFFFFFFFu, key[kE - 1 - s], lanes - 1);
#pragma unroll
      for (int s = 0; s < kE; ++s)
        key[s] = lower ? min(key[s], other[s]) : max(key[s], other[s]);
    }
#pragma unroll
    for (int log_j = log_size - 2; log_j >= 0; --log_j) {
      const int j = 1 << log_j;
      if (j < kE) {
#pragma unroll
        for (int s = 0; s < kE; ++s) {
          if ((s & j) == 0) {
            const uint32_t lo = min(key[s], key[s | j]);
            key[s | j] = max(key[s], key[s | j]);
            key[s] = lo;
          }
        }
      } else {
        const int mask = j / kE;
        const bool lower = (lane & mask) == 0;
#pragma unroll
        for (int s = 0; s < kE; ++s) {
          const uint32_t other = __shfl_xor_sync(0xFFFFFFFFu, key[s], mask);
          key[s] = lower ? min(key[s], other) : max(key[s], other);
        }
      }
    }
  }
}

template <int kE>
__global__ void __launch_bounds__(kThreads)
kth_warp_sort_kernel(const float* __restrict__ x, float* __restrict__ out, long long m, int w,
                     int k) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // warps past the last row stay for the shuffles: they redo row 0, store nothing
  const bool live = row < m;
  const float* xr = x + (live ? row : 0) * w;
  uint32_t key[kE];
#pragma unroll
  for (int s = 0; s < kE; ++s) {
    const int j = lane + 32 * s;  // any order will do for a sort: coalesced
    key[s] = j < w ? float_to_key(xr[j]) : 0xFFFFFFFFu;
  }
  warp_sort<kE>(key, lane);
  const int pos = k - 1;
  const uint32_t mine = select_register<kE>(key, pos % kE);
  const uint32_t chosen = __shfl_sync(0xFFFFFFFFu, mine, pos / kE);
  if (live && lane == 0) out[row] = key_to_float(chosen);
}

template <bool kBig>
int launch_noise(const float* x, float* out, const NoiseLaunch& p, unsigned blocks,
                 size_t smem, cudaStream_t stream) {
  static size_t granted[kMaxDevices] = {};  // bytes granted to this instance, by device
  const int err = grant_dynamic_shared(os_cfar_2d_noise_kernel<kBig>, smem, granted);
  if (err != 0) return err;
  os_cfar_2d_noise_kernel<kBig><<<blocks, kThreads, smem, stream>>>(x, out, p);
  return static_cast<int>(cudaGetLastError());
}

// Whether the host's launch geometry fits the map, the window and what the
// kernel assumes of it: a geometry that does not would give wrong noise
// values without any CUDA error.
bool noise_launch_is_consistent(const NoiseLaunch& p, int batch) {
  if (batch < 1 || p.tr < 0 || p.td < 0 || p.gr < 0 || p.gd < 0) return false;
  const int win_r = 2 * (p.tr + p.gr) + 1, win_d = 2 * (p.td + p.gd) + 1;
  const int r_out = p.rows - win_r + 1, d_out = p.cols - win_d + 1;
  const int n_train = win_r * win_d - (2 * p.gr + 1) * (2 * p.gd + 1);
  if (r_out < 1 || d_out < 1 || p.k < 1 || p.k > n_train) return false;
  if (p.tile_r < 1 || p.tile_d < 4 || p.tile_d % 4 != 0) return false;
  if (p.tiles_r != (r_out + p.tile_r - 1) / p.tile_r) return false;
  if (p.tiles_d != (d_out + p.tile_d - 1) / p.tile_d) return false;
  const int region_d = p.tile_d + win_d - 1;
  const long long region = static_cast<long long>(p.tile_r + win_r - 1) * region_d;
  // a row of a rank copy holds the region and the shifted copy's overhang
  if (p.words_per_row % 2 != 1 || p.words_per_row < region_d / 2 + 1) return false;
  // block_sort has 1, 2, 4, ... 64 keys a thread
  if (!is_power_of_two(p.sort_size) || p.sort_size < kThreads || p.sort_size > 64 * kThreads ||
      p.sort_size < region)
    return false;
  // a rank takes `passes` bits and, offset by kRankBase, stays a finite half
  if (p.passes < 1 || p.passes > 14 || (1LL << p.passes) < region) return false;
  // a lane's compare masks sum in 16 bits a half word
  if (static_cast<long long>(win_r) * (win_d / 2 + 2) >= 65536) return false;
  return is_power_of_two(p.row_split) && p.row_split <= 32;
}

}  // namespace

// x: float32 [batch, rows, cols] contiguous, the map at least one window in
// each axis; out: float32 [batch, rows-2(tr+gr), cols-2(td+gd)]; 1 <= k <=
// number of training cells; the rest is the host's launch geometry
// (ops/kernels/os_cfar.py :: noise_launch_geometry), whose shared-memory
// bytes are recomputed here.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue without a
// launch for a geometry that does not fit the map, the window or the kernel.
extern "C" int os_cfar_2d_noise(const void* x, void* out, int batch, int rows,
                                int cols, int tr, int td, int gr, int gd, int k,
                                int tile_r, int tile_d, int tiles_r, int tiles_d,
                                int words_per_row, int sort_size, int passes,
                                int row_split, void* stream) {
  const NoiseLaunch p = {rows, cols, tr, td, gr, gd, k, tile_r, tile_d, tiles_r, tiles_d,
                         words_per_row, sort_size, passes, row_split};
  if (!noise_launch_is_consistent(p, batch)) return static_cast<int>(cudaErrorInvalidValue);
  const int region_r = tile_r + 2 * (tr + gr);
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(sort_size) + sort_size / 32 +
                                          2 * static_cast<size_t>(region_r) * words_per_row);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(batch) * tiles_r * tiles_d);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sort_size > 32 * kThreads) return launch_noise<true>(xp, op, p, blocks, smem, s);
  return launch_noise<false>(xp, op, p, blocks, smem, s);
}

namespace {

template <int kW>
int launch_network(const float* x, float* out, long long m, int k, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  kth_network_kernel<kW><<<blocks, kThreads, 0, s>>>(x, out, m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: float32 [m, w] contiguous; out: float32 [m]; 1 <= k <= w.  The width picks
// the kernel: the sorting network up to 32 columns, the warp-wide sort up to
// 256 and the search above.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue without a launch
// for arguments outside those ranges.
extern "C" int kth_smallest(const void* x, void* out, long long m, int w, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (m < 1 || w < 1 || k < 1 || k > w) return static_cast<int>(cudaErrorInvalidValue);
  if (w <= 32) {
    switch (w) {
#define KTH_WIDTH(W) \
  case W:            \
    return launch_network<W>(xp, op, m, k, s);
      KTH_WIDTH(1) KTH_WIDTH(2) KTH_WIDTH(3) KTH_WIDTH(4) KTH_WIDTH(5) KTH_WIDTH(6)
      KTH_WIDTH(7) KTH_WIDTH(8) KTH_WIDTH(9) KTH_WIDTH(10) KTH_WIDTH(11) KTH_WIDTH(12)
      KTH_WIDTH(13) KTH_WIDTH(14) KTH_WIDTH(15) KTH_WIDTH(16) KTH_WIDTH(17) KTH_WIDTH(18)
      KTH_WIDTH(19) KTH_WIDTH(20) KTH_WIDTH(21) KTH_WIDTH(22) KTH_WIDTH(23) KTH_WIDTH(24)
      KTH_WIDTH(25) KTH_WIDTH(26) KTH_WIDTH(27) KTH_WIDTH(28) KTH_WIDTH(29) KTH_WIDTH(30)
      KTH_WIDTH(31) KTH_WIDTH(32)
#undef KTH_WIDTH
    }
  }
  // a warp a row from here on
  const unsigned blocks = static_cast<unsigned>((m * 32 + kThreads - 1) / kThreads);
  if (w <= 64) {
    kth_warp_sort_kernel<2><<<blocks, kThreads, 0, s>>>(xp, op, m, w, k);
  } else if (w <= 128) {
    kth_warp_sort_kernel<4><<<blocks, kThreads, 0, s>>>(xp, op, m, w, k);
  } else if (w <= 256) {
    kth_warp_sort_kernel<8><<<blocks, kThreads, 0, s>>>(xp, op, m, w, k);
  } else {
    kth_search_kernel<<<blocks, kThreads, 0, s>>>(xp, op, m, w, k);
  }
  return static_cast<int>(cudaGetLastError());
}
