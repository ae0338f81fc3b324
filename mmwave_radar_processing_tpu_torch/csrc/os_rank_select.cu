// Rank selection for OS-CFAR on Hopper (sm_90a): the k-th smallest of a set of
// float32 values, exact.  Two entry points share one device routine.
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
// Selection: a bitwise search on the order-preserving integer image of the
// float.  key(x) flips the sign bit of a non-negative float and all bits of a
// negative one, so unsigned key order is float order.  The k-th smallest key
// is the largest v with #{key < v} <= k-1; v is built from the top bit down,
// one counting pass over the set per bit: 32 passes of n compare-adds.  The
// result is one of the inputs, bit for bit, so it equals
// sort(values)[k-1] under == (-0.0 and +0.0 have different keys but compare
// equal).  +inf sorts last.  NaNs are not engineered: one with the sign bit
// clear sorts after +inf, as torch.sort places it; one with the sign bit set
// sorts before -inf, where torch.sort would place it last.
//
// Neither design carries over the TPU kernels' layout (windows padded to 256
// slots with +inf, a full bitonic network over a [256, R', D'] scratch, rows
// padded to 128 lanes and tiles of 256): Hopper threads branch and index
// shared memory freely, so nothing is padded and nothing is sorted.
//
// os_cfar_2d_noise: a block copies its frame's map into shared memory as keys
// (63 x 70 x 4 B = 17.6 KB on the flagship config; up to 227 KB), then each
// thread selects for its own core cells, reading the training cells from
// shared memory; neighbouring threads take neighbouring columns (consecutive
// words, no bank conflicts).  The ~220x window expansion never reaches device
// memory.  A frame is split over gridDim.y blocks, chosen by the host so that
// a small batch still fills the card.  Cost: a flagship frame moves 17.6 KB
// in and 10.5 KB out, and this search spends 47*56 cells x 32 passes x 220
// compare-adds on it (1.9e7 a frame), each with a shared-memory read: the
// integer ALU and the shared-memory reads limit the kernel, not device memory.
// That count is the search's own, not the function's bound: a selection needs
// about n + min(k, n-k) compares a cell (286 at n = 220, k = 154) against this search's 7,040 compare-adds.
//
// kth_smallest: a group of 1 to 32 lanes a row (a power of two, the smallest
// that gives each lane at most 8 columns; chosen from W by the entry point),
// the group's counts summed with xor shuffles; the ragged edge is masked,
// nothing is padded in memory.  Up to W = 256 a lane reads its columns once
// and keeps their keys in 8 registers over the 32 passes (slots past the
// row's end hold the largest key, which no pass counts); above that each pass
// re-reads the row, which stays in L1, and converts again.  Keeping the keys
// matters: converting every element in every pass, with a thread a row (rows
// 4W bytes apart across a warp), took 3.4 times as long at [2451456, 24] and
// 1.75 times at [168448, 220] (NVIDIA H100 80GB HBM3, 700 W).  Bound: [M, W]
// moves 4*M*(W+1) bytes, and a selection needs about W + min(k, W-k) compares
// a row: bytes.  The search's own 32*M*W compare-adds are what it spends.
//
// Built by nvcc into a shared library with plain C entry points, loaded with
// ctypes (mmwave_radar_processing_tpu_torch/ops/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(kThreads)
os_cfar_2d_noise_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int rows, int cols, int tr, int td, int gr, int gd, int k) {
  extern __shared__ uint32_t keys[];
  const int n = rows * cols;
  const float* xb = x + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) keys[i] = float_to_key(xb[i]);
  __syncthreads();

  const int win_r = 2 * (tr + gr) + 1, win_d = 2 * (td + gd) + 1;
  const int r_out = rows - win_r + 1, d_out = cols - win_d + 1;
  const int n_out = r_out * d_out;
  const int gr1 = tr + 2 * gr, gd1 = td + 2 * gd;  // guard box: [tr, gr1] x [td, gd1]
  float* ob = out + static_cast<size_t>(blockIdx.x) * n_out;

  for (int idx = blockIdx.y * blockDim.x + threadIdx.x; idx < n_out;
       idx += blockDim.x * gridDim.y) {
    const int r = idx / d_out;
    const int c = idx - r * d_out;
    // the window of core cell (r, c) starts at map cell (r, c)
    const uint32_t* win = keys + r * cols + c;
    const uint32_t key = kth_smallest_key(k, [&](uint32_t t) {
      int count = 0;
      for (int i = 0; i < win_r; ++i) {
        const uint32_t* row = win + i * cols;
        if (i < tr || i > gr1) {
          for (int j = 0; j < win_d; ++j) count += row[j] < t ? 1 : 0;
        } else {
          for (int j = 0; j < td; ++j) count += row[j] < t ? 1 : 0;
          for (int j = gd1 + 1; j < win_d; ++j) count += row[j] < t ? 1 : 0;
        }
      }
      return count;
    });
    ob[idx] = key_to_float(key);
  }
}

constexpr int kKeysPerLane = 8;

// `group` lanes a row (a power of two up to 32, so a group never straddles a
// warp).  kInRegisters: group * kKeysPerLane >= w, each lane keeps its keys.
template <bool kInRegisters>
__global__ void __launch_bounds__(kThreads)
kth_smallest_kernel(const float* __restrict__ x, float* __restrict__ out,
                    long long m, int w, int k, int group) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / group;
  const int lane = threadIdx.x % group;
  // lanes past the last row stay for the shuffles: they redo row 0, store nothing
  const bool live = row < m;
  const float* xr = x + (live ? row : 0) * w;
  uint32_t keys[kKeysPerLane];
  if constexpr (kInRegisters) {
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + i * group;
      keys[i] = j < w ? float_to_key(xr[j]) : 0xFFFFFFFFu;
    }
  }
  const uint32_t key = kth_smallest_key(k, [&](uint32_t t) {
    int count = 0;
    if constexpr (kInRegisters) {
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) count += keys[i] < t ? 1 : 0;
    } else {
      for (int j = lane; j < w; j += group) count += float_to_key(xr[j]) < t ? 1 : 0;
    }
    for (int o = group >> 1; o > 0; o >>= 1)
      count += __shfl_xor_sync(0xFFFFFFFFu, count, o);
    return count;
  });
  if (live && lane == 0) out[row] = key_to_float(key);
}

}  // namespace

// x: float32 [batch, rows, cols] contiguous, the map at least one window in
// each axis; out: float32 [batch, rows-2(tr+gr), cols-2(td+gd)]; 1 <= k <=
// number of training cells; splits >= 1 blocks share a frame.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int os_cfar_2d_noise(const void* x, void* out, int batch, int rows,
                                int cols, int tr, int td, int gr, int gd, int k,
                                int splits, void* stream) {
  const size_t smem = static_cast<size_t>(rows) * cols * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        os_cfar_2d_noise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  os_cfar_2d_noise_kernel<<<dim3(batch, splits), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, cols, tr, td,
      gr, gd, k);
  return static_cast<int>(cudaGetLastError());
}

// x: float32 [m, w] contiguous; out: float32 [m]; 1 <= k <= w.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kth_smallest(const void* x, void* out, long long m, int w, int k,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  int group = 1;
  while (group < 32 && group * kKeysPerLane < w) group <<= 1;
  const unsigned blocks = static_cast<unsigned>((m * group + kThreads - 1) / kThreads);
  if (group * kKeysPerLane >= w) {
    kth_smallest_kernel<true><<<blocks, kThreads, 0, s>>>(xp, op, m, w, k, group);
  } else {
    kth_smallest_kernel<false><<<blocks, kThreads, 0, s>>>(xp, op, m, w, k, group);
  }
  return static_cast<int>(cudaGetLastError());
}
