// Counting OS-CFAR 2D detection for Hopper (sm_90a), with and without the
// compaction of the first detections.
//
// Replaces the TPU kernel
//   mmwave_radar_processing_tpu/ops/pallas/os_cfar.py :: os_cfar_2d_detect_fused
// (body _detect_kernel).  Same arithmetic as the XLA form in
// mmwave_radar_processing_tpu/ops/cfar.py :: os_2d_detect: an interior cell
// (r, c) is detected iff
//     #{training offsets (i, j) : alpha * x[r-er+i][c-ed+j] < x[r][c]} >= k
// with the float32 product rounded once (__fmul_rn: nothing to contract with).
// Cells within er = tr+gr rows or ed = td+gd columns of an edge are 0, as are
// all cells of a map smaller than one window (the wrapper answers that without
// a launch).  The TPU layout (batch on the 128-lane axis, transposes on the way
// in and out, edge padding built by concatenation) is not carried over.
//
// Two entry points, one kernel body:
//   os_cfar_2d_detect          the mask, uint8 [B, R, D], edges included;
//   os_cfar_2d_detect_compact  no mask in device memory: one block holds a
//     whole frame and its epilogue writes the first `capacity` detections in
//     row-major order as (rows, cols) int64, valid bool and count int32 clamped
//     to capacity, padding entries 0: what ops/masked.mask_to_indices_2d gives
//     for the mask.  The order comes from a block prefix sum over the mask in
//     shared memory (a chunk of consecutive cells a thread), no atomics.
//
// What bounds it on this card: a flagship frame ([63, 70], a 17 x 15 window
// less a 7 x 5 guard box: 220 training cells, 47 x 56 interior cells) moves
// 17.6 KB in and 4.4 KB out, and needs 2,632 x 220 compares, counts and
// products: operations (26 us for 1024 frames at the float32 peak), far above
// its bytes (7 us).  The first kernel of this file spent about six
// instructions and a shared-memory load on each of the 255 window positions of
// a cell, over all 4,410 cells of a frame.  This design spends two
// instructions (a compare and a predicated add) and a third of a load a
// training cell:
//   1. Scale once.  The block writes alpha * x, rounded once, into shared
//      memory for its tile's region (the tile's cells and their windows); the
//      cut itself is read from the map.  The compare is then a[j] < cut.
//   2. No guard predicate.  A window is the rows above the guard box and the
//      rows below it (its whole width), and the rows through it (a run of
//      training columns on either side).  The two run lengths reach the loops
//      as compile-time constants (launch_helpers.cuh: a bisection, 5 uniform
//      branches; run-time loops beyond 31 columns), so a run unrolls.
//   3. A strip of 4 neighbouring cells a thread: a window row's len + 3 scaled
//      values are loaded once, as 16-byte vectors, and each is compared with
//      the cuts it trains.  The run right of the guard box starts at any
//      column, so a second copy of the region, shifted by that column's
//      remainder mod 4, keeps its loads aligned too.
//   4. Only interior strips are handed out (47 rows x 14 strips at the
//      flagship); lanes run along a row's strips and on into the next row,
//      and the row stride of the copies is chosen so that 8 consecutive lanes'
//      vectors fall on all 32 banks.
//   5. At a small batch a frame is cut into tiles of core cells over several
//      blocks and a strip's window rows are shared out over 2 to 32 lanes
//      whose counts are summed by shuffle
//      (ops/kernels/os_cfar.py :: detect_launch_geometry).  A tile on the
//      map's edge also writes the edge's zeros, in one coalesced pass with its
//      own cells.
//
// Times (NVIDIA H100 80GB HBM3, 700.00 W; [1024, 63, 70], in turns with the
// first kernel in one job).  Launch to launch, the host's time to issue a
// call included: the first kernel 0.348-0.354 ms; this design with compare
// masks summed two to an add 0.133-0.136 (SASS: FSETP, SEL and half an IADD3 a
// compare); a compare to 1.0f and a float add 0.079; a compare and a
// predicated add 0.076, which is kept: 17 thousand clocks a frame on an SM,
// against 13.5 thousand if the compare runs at half rate.  Queued behind a
// busy device, so that the time is the device's alone: the mask entry 0.0720,
// the compacting entry 0.0714, the mask entry followed by mask_to_indices_2d
// (torch.topk) 0.3235.
//
// Built by nvcc into a shared library with plain C entry points, loaded with
// ctypes (mmwave_radar_processing_tpu_torch/ops/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_helpers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 4;  // cells a thread: STRIP of ops/kernels/os_cfar.py

// The launch geometry, computed on the host
// (ops/kernels/os_cfar.py :: detect_launch_geometry).
struct DetectLaunch {
  int rows, cols, tr, td, gr, gd, k;
  float alpha;
  int tile_r, tile_d, tiles_r, tiles_d;  // core cells a tile (tile_d: 4 divides it), tiles a frame
  int stride;                            // words a row of a copy of the region: 4 divides it
  int row_split;                         // lanes that share a strip's window rows
  int capacity;                          // the compacting entry: detections kept a frame
};

// count += a < cut: a compare into a predicate and an add under it, pinned as
// two instructions.  (A mask from set.lt.u32.f32 summed two to a three-input
// add came out as FSETP, SEL and half an IADD3 a compare, and took 1.75 times
// as long; see the times above.)
__device__ __forceinline__ void count_below(int& count, float a, float cut) {
  asm("{ .reg .pred p; setp.lt.f32 p, %1, %2; @p add.s32 %0, %0, 1; }"
      : "+r"(count)
      : "f"(a), "f"(cut));
}

// Count, for the strip's 4 cells, the scaled values below their cuts in a run
// of `len` columns: cell q takes p[q .. q + len).  With the length a constant,
// p is 16-byte aligned and is read as vectors (up to 3 words past the run's
// end, which the row stride allows for); else a run-time loop of scalar loads.
template <class Len>
__device__ __forceinline__ void count_run(const float* __restrict__ p, Len len,
                                          const float (&cut)[kStrip], int (&count)[kStrip]) {
  if constexpr (std::is_same_v<Len, int>) {
    for (int j = 0; j < len + kStrip - 1; ++j) {
      const float a = p[j];
#pragma unroll
      for (int q = 0; q < kStrip; ++q) {
        if (j >= q && j < q + len) count_below(count[q], a, cut[q]);
      }
    }
  } else {
    constexpr int kLen = Len{};
    if constexpr (kLen > 0) {
      constexpr int kVectors = (kLen + kStrip - 1 + 3) / 4;
      float a[4 * kVectors];
#pragma unroll
      for (int v = 0; v < kVectors; ++v) {
        const float4 t = reinterpret_cast<const float4*>(p)[v];
        a[4 * v] = t.x, a[4 * v + 1] = t.y, a[4 * v + 2] = t.z, a[4 * v + 3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < kStrip; ++q) {
#pragma unroll
        for (int j = 0; j < kLen; ++j) count_below(count[q], a[q + j], cut[q]);
      }
    }
  }
}

// kCompact: one tile a frame; the epilogue writes the first detections, not the mask.
template <bool kCompact>
__global__ void __launch_bounds__(kThreads, 4)
os_cfar_2d_detect_kernel(const float* __restrict__ x, uint8_t* __restrict__ mask_out,
                         long long* __restrict__ rows_out, long long* __restrict__ cols_out,
                         uint8_t* __restrict__ valid_out, int* __restrict__ count_out,
                         const DetectLaunch p) {
  extern __shared__ float4 smem_vectors[];  // 16-byte aligned
  __shared__ int warp_total[kWarps];
  const int td = p.td, er = p.tr + p.gr, ed = td + p.gd;
  const int win_r = 2 * er + 1, win_d = 2 * ed + 1;
  const int r_out = p.rows - 2 * er, d_out = p.cols - 2 * ed;
  const int gr1 = p.tr + 2 * p.gr;        // the guard box's last row
  const int right = td + 2 * p.gd + 1;    // the first column after the guard box
  const int shift = right & 3;
  const int tiles = p.tiles_r * p.tiles_d;
  const int tile = blockIdx.x % tiles;
  const size_t frame = blockIdx.x / tiles;
  const int tile_row = tile / p.tiles_d, tile_col = tile % p.tiles_d;
  const int r0 = tile_row * p.tile_r, c0 = tile_col * p.tile_d;
  const int cells_r = min(p.tile_r, r_out - r0), cells_d = min(p.tile_d, d_out - c0);
  const int reg_r = cells_r + win_r - 1, stride = p.stride;
  const int copy_words = (p.tile_r + win_r - 1) * stride;
  const int warp = threadIdx.x >> 5, lane32 = threadIdx.x & 31;

  // scaled[rr][cc] = alpha * x at region cell (rr, cc); shifted[rr][cc] =
  // scaled[rr][cc + shift]; det[r * cells_d + c]: the tile's mask
  float* scaled = reinterpret_cast<float*>(smem_vectors);
  float* shifted = shift ? scaled + copy_words : scaled;
  uint8_t* det = reinterpret_cast<uint8_t*>(scaled + (shift ? 2 : 1) * copy_words);
  const float* xb = x + frame * p.rows * p.cols + static_cast<size_t>(r0) * p.cols + c0;

  // 1. the region, scaled; columns past the map are 0 (only cells past the
  //    tile's last read them)
  for (int rr = warp; rr < reg_r; rr += kWarps) {
    for (int cc = lane32; cc < stride; cc += 32) {
      const float v = c0 + cc < p.cols ? __fmul_rn(p.alpha, xb[rr * p.cols + cc]) : 0.0f;
      scaled[rr * stride + cc] = v;
      if (shift) {
        if (cc >= shift) shifted[rr * stride + cc - shift] = v;
        if (cc >= stride - shift) shifted[rr * stride + cc] = 0.0f;
      }
    }
  }
  __syncthreads();

  // 2. counts: a group of `row_split` lanes shares a strip of 4 cells
  const int strips = (cells_d + kStrip - 1) / kStrip;
  const int groups = cells_r * strips;
  const int split = p.row_split, lane = threadIdx.x % split;
  const int first_group = threadIdx.x / split, groups_a_round = kThreads / split;
  const int guard_rows = 2 * p.gr + 1;
  for (int g0 = first_group; g0 - first_group < groups; g0 += groups_a_round) {
    // lanes past the last strip stay for the shuffles: they redo strip 0, store nothing
    const bool live = g0 < groups;
    const int g = live ? g0 : 0;
    const int r = g / strips, strip = g - r * strips;
    float cut[kStrip];
#pragma unroll
    for (int q = 0; q < kStrip; ++q) {
      const int c = kStrip * strip + q;
      cut[q] = c < cells_d ? xb[(r + er) * p.cols + ed + c] : 0.0f;
    }
    int count[kStrip] = {0, 0, 0, 0};
    // window row 0 of the strip's first cell, and the same in the shifted
    // copy at the first column after the guard box: both on a 16-byte boundary
    const float* left = scaled + r * stride + kStrip * strip;
    const float* after = shifted + r * stride + kStrip * strip + (right - shift);
    // the 2*tr rows above and below the guard box: the window's whole width
    with_run_length(win_d, [&](auto len) {
      for (int j = lane; j < 2 * p.tr; j += split) {
        count_run(left + (j < p.tr ? j : j + guard_rows) * stride, len, cut, count);
      }
    });
    // the rows through the guard box: the training columns on either side
    with_run_length(td, [&](auto len) {
      for (int i = p.tr + lane; i <= gr1; i += split) {
        count_run(left + i * stride, len, cut, count);
        count_run(after + i * stride, len, cut, count);
      }
    });
#pragma unroll
    for (int q = 0; q < kStrip; ++q) {
      int total = count[q];
      for (int o = split >> 1; o > 0; o >>= 1) total += __shfl_xor_sync(0xFFFFFFFFu, total, o);
      const int c = kStrip * strip + q;
      if (live && lane == 0 && c < cells_d) det[r * cells_d + c] = total >= p.k ? 1 : 0;
    }
  }
  __syncthreads();

  if constexpr (!kCompact) {
    // 3. the tile's cells, and the map's edge where the tile touches it
    const int top = tile_row == 0 ? 0 : er + r0;
    const int bottom = tile_row == p.tiles_r - 1 ? p.rows : er + r0 + cells_r;
    const int first = tile_col == 0 ? 0 : ed + c0;
    const int last = tile_col == p.tiles_d - 1 ? p.cols : ed + c0 + cells_d;
    uint8_t* ob = mask_out + frame * p.rows * p.cols;
    for (int row = top + warp; row < bottom; row += kWarps) {
      const int r = row - er - r0;
      const bool core_row = r >= 0 && r < cells_r;
      for (int col = first + lane32; col < last; col += 32) {
        const int c = col - ed - c0;
        ob[row * p.cols + col] = core_row && c >= 0 && c < cells_d ? det[r * cells_d + c] : 0;
      }
    }
  } else {
    // 3. the first `capacity` detections in row-major order: a thread takes a
    //    chunk of consecutive cells, the chunks' counts are summed over the
    //    block, and each thread writes its detections from its offset on
    const int n = r_out * d_out, chunk = (n + kThreads - 1) / kThreads;
    const int begin = min(n, static_cast<int>(threadIdx.x) * chunk), end = min(n, begin + chunk);
    int mine = 0;
    for (int i = begin; i < end; ++i) mine += det[i];
    int upto = mine;  // inclusive over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int below = __shfl_up_sync(0xFFFFFFFFu, upto, o);
      if (lane32 >= o) upto += below;
    }
    if (lane32 == 31) warp_total[warp] = upto;
    __syncthreads();
    int offset = upto - mine, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) offset += warp_total[w];
      total += warp_total[w];
    }
    const size_t slot0 = frame * p.capacity;
    int r = begin / d_out, c = begin - r * d_out;
    for (int i = begin; i < end; ++i) {
      if (det[i]) {
        if (offset < p.capacity) {
          rows_out[slot0 + offset] = er + r;
          cols_out[slot0 + offset] = ed + c;
          valid_out[slot0 + offset] = 1;
        }
        ++offset;
      }
      if (++c == d_out) c = 0, ++r;
    }
    for (int slot = total + threadIdx.x; slot < p.capacity; slot += kThreads) {
      rows_out[slot0 + slot] = 0;
      cols_out[slot0 + slot] = 0;
      valid_out[slot0 + slot] = 0;
    }
    if (threadIdx.x == 0) count_out[frame] = min(total, p.capacity);
  }
}

// Bytes of dynamic shared memory: one or two copies of the region and the mask.
size_t shared_bytes(const DetectLaunch& p) {
  const int region_r = p.tile_r + 2 * (p.tr + p.gr);
  const int copies = ((p.td + 2 * p.gd + 1) & 3) ? 2 : 1;
  const size_t mask = (static_cast<size_t>(p.tile_r) * p.tile_d + 15) / 16 * 16;
  return sizeof(float) * copies * region_r * p.stride + mask;
}

// Whether the host's launch geometry fits the map, the window and what the
// kernel assumes of it: a geometry that does not would give a wrong mask
// without any CUDA error.
bool detect_launch_is_consistent(const DetectLaunch& p, int batch, bool compact) {
  if (batch < 1 || p.tr < 0 || p.td < 0 || p.gr < 0 || p.gd < 0 || p.k < 1) return false;
  const int win_r = 2 * (p.tr + p.gr) + 1, win_d = 2 * (p.td + p.gd) + 1;
  const int r_out = p.rows - win_r + 1, d_out = p.cols - win_d + 1;
  if (r_out < 1 || d_out < 1) return false;
  if (p.tile_r < 1 || p.tile_d < kStrip || p.tile_d % kStrip != 0) return false;
  if (p.tiles_r != (r_out + p.tile_r - 1) / p.tile_r) return false;
  if (p.tiles_d != (d_out + p.tile_d - 1) / p.tile_d) return false;
  // a row of a copy holds the region and the 3 words a vector may read past a run
  if (p.stride % 4 != 0 || p.stride < p.tile_d + win_d - 1 + 4) return false;
  if (!is_power_of_two(p.row_split) || p.row_split > 32) return false;
  if (static_cast<long long>(p.rows) * p.cols > 0x7FFFFFFF) return false;
  if (compact && (p.tiles_r != 1 || p.tiles_d != 1 || p.capacity < 1)) return false;
  return shared_bytes(p) <= static_cast<size_t>(kMaxSharedBytes);
}

template <bool kCompact>
int launch_detect(const float* x, uint8_t* mask, long long* rows_out, long long* cols_out,
                  uint8_t* valid_out, int* count_out, const DetectLaunch& p, int batch,
                  cudaStream_t stream) {
  static size_t granted[kMaxDevices] = {};
  if (!detect_launch_is_consistent(p, batch, kCompact)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes(p);
  const int err = grant_dynamic_shared(os_cfar_2d_detect_kernel<kCompact>, smem, granted);
  if (err != 0) return err;
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(batch) * p.tiles_r * p.tiles_d);
  os_cfar_2d_detect_kernel<kCompact><<<blocks, kThreads, smem, stream>>>(
      x, mask, rows_out, cols_out, valid_out, count_out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: float32 [batch, rows, cols] contiguous, the map at least one window in
// each axis; out: uint8/bool, same shape; k >= 1; the rest is the host's launch
// geometry (ops/kernels/os_cfar.py :: detect_launch_geometry), whose
// shared-memory bytes are recomputed here.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue without a launch
// for a geometry that does not fit the map, the window or the kernel.
extern "C" int os_cfar_2d_detect(const void* x, void* out, int batch, int rows, int cols,
                                 int tr, int td, int gr, int gd, int k, float alpha,
                                 int tile_r, int tile_d, int tiles_r, int tiles_d, int stride,
                                 int row_split, void* stream) {
  const DetectLaunch p = {rows, cols, tr, td, gr, gd, k, alpha, tile_r, tile_d,
                          tiles_r, tiles_d, stride, row_split, 0};
  return launch_detect<false>(static_cast<const float*>(x), static_cast<uint8_t*>(out), nullptr,
                              nullptr, nullptr, nullptr, p, batch,
                              static_cast<cudaStream_t>(stream));
}

// As os_cfar_2d_detect, one tile a frame, but writes rows_out and cols_out
// (int64 [batch, capacity]), valid_out (uint8/bool [batch, capacity]) and
// count_out (int32 [batch]) in place of the mask.
extern "C" int os_cfar_2d_detect_compact(const void* x, void* rows_out, void* cols_out,
                                         void* valid_out, void* count_out, int capacity,
                                         int batch, int rows, int cols, int tr, int td, int gr,
                                         int gd, int k, float alpha, int tile_r, int tile_d,
                                         int stride, int row_split, void* stream) {
  const DetectLaunch p = {rows, cols, tr, td, gr, gd, k, alpha, tile_r, tile_d,
                          1, 1, stride, row_split, capacity};
  return launch_detect<true>(static_cast<const float*>(x), nullptr,
                             static_cast<long long*>(rows_out), static_cast<long long*>(cols_out),
                             static_cast<uint8_t*>(valid_out), static_cast<int*>(count_out), p,
                             batch, static_cast<cudaStream_t>(stream));
}
