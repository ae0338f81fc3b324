// The DBS velocity-steered pick on Hopper (sm_90a):
//   out[b, r, d] = | sum_{a < A} spec[b, a, r, bins[b, d]] * w[a, d] |
// over a range-Doppler spectrum spec [B, A, ns, L] complex64, weights w [A, D]
// complex64 and each frame's Doppler bin per output angle bins [B, D] int64;
// out [B, ns, D] float32.
//
// Replaces no TPU kernel: the JAX package forms the whole windowed angle DFT
// of the cube and gathers from it in plain XLA
// (mmwave_radar_processing_tpu/parallel/spectral_pipeline.py).  The port
// first carried that over as a K = A complex GEMM that wrote the
// [B, ns, L, M] cube (282,240 values a frame at the RadVel DBS deployment's
// 63 x 70 x 64; 9.25 GB a call of 4096 frames) and a gather that kept 6,300 of
// them a frame.  Each kept value is one point of the angle DFT at a single
// Doppler bin, so it needs only the A antenna values at (range bin, that
// bin): w is the angle DFT's column of each output angle, and the cube is
// never formed.
//
// The arithmetic, in float32 with no contraction into FMAs: each product
// (sr*wr - si*wi, sr*wi + si*wr), summed in antenna order from antenna 0;
// the magnitude sqrt(re*re + im*im), ops/dft.cabs's formula (not hypot).  A
// bin outside [0, L) reads as NaN: the card cannot raise.
//
// What bounds it: bytes.  A frame reads its spectrum once (8 A ns L bytes:
// 141 KB at A = 4, ns = 63, L = 70) and its bins (8 D), and writes 4 ns D
// (25.2 KB at D = 100): 0.052 ms per 1024 frames at 3.35 TB/s.  The weights
// (8 A D) are shared by every frame and stay in L2.  The design:
//   1. a block takes one frame and a tile of range rows (about kTileBytes of
//      spectrum: 9 rows of 2.2 KB at the deployment's widths, 7 tiles a
//      frame);
//   2. it stages the frame's bins, the weights and the tile's A x rows x L
//      values in shared memory, the tile with asynchronous 16-byte copies
//      (8-byte where L is odd or the spectrum is off 16 bytes), each
//      antenna's rows being one contiguous run;
//   3. one thread an output (r, d) of the tile, walking the tile's
//      contiguous rows x D outputs, so the stores are coalesced along d;
//      a thread reads A values at its row and bin, A weights and one bin
//      from shared memory.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_helpers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAntennas = 16;    // A a block stages; more is refused
constexpr int kTileBytes = 20480;   // spectrum bytes a block aims at

// Complex values a block keeps of one antenna's tile: rows * L, rounded up to
// even so that each antenna's run starts on 16 bytes.
__host__ __device__ __forceinline__ long long antenna_stride(int rows, int loops) {
  const long long n = static_cast<long long>(rows) * loops;
  return n + (n & 1);
}

__host__ __forceinline__ size_t shared_bytes(int a_len, int rows, int loops, int d_len) {
  return sizeof(float2) * (a_len * antenna_stride(rows, loops)
                           + static_cast<long long>(a_len) * d_len)
         + sizeof(int) * static_cast<size_t>(d_len);
}

// kVec: L is even and spec is 16-byte aligned, so every antenna's tile of
// whole rows starts on 16 bytes and holds whole pairs of values.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dbs_pick_kernel(const float2* __restrict__ spec, const float2* __restrict__ weights,
                const long long* __restrict__ bins, int a_len, int ns, int loops, int d_len,
                int rows, int row_tiles, float* __restrict__ out) {
  extern __shared__ float4 stage4[];
  const long long stride = antenna_stride(rows, loops);
  float2* s_spec = reinterpret_cast<float2*>(stage4);
  float2* s_w = s_spec + a_len * stride;
  int* s_bin = reinterpret_cast<int*>(s_w + a_len * d_len);

  const int tile = static_cast<int>(blockIdx.x % row_tiles);
  const long long b = blockIdx.x / row_tiles;
  const int r0 = tile * rows;
  const int nr = ns - r0 < rows ? ns - r0 : rows;
  const int n = nr * loops;  // values of one antenna's tile
  const long long plane = static_cast<long long>(ns) * loops;
  const float2* src = spec + b * a_len * plane + static_cast<long long>(r0) * loops;

  if constexpr (kVec) {
    const int n2 = n >> 1;
    for (int k = threadIdx.x; k < a_len * n2; k += kThreads) {
      const int a = k / n2, j = k - a * n2;
      __pipeline_memcpy_async(s_spec + a * stride + 2 * j, src + a * plane + 2 * j, 16);
    }
  } else {
    for (int k = threadIdx.x; k < a_len * n; k += kThreads) {
      const int a = k / n, j = k - a * n;
      __pipeline_memcpy_async(s_spec + a * stride + j, src + a * plane + j, 8);
    }
  }
  __pipeline_commit();
  for (int k = threadIdx.x; k < a_len * d_len; k += kThreads) s_w[k] = __ldg(weights + k);
  for (int d = threadIdx.x; d < d_len; d += kThreads) {
    const long long v = __ldg(bins + b * d_len + d);
    s_bin[d] = v >= 0 && v < loops ? static_cast<int>(v) : -1;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  float* dst = out + (b * ns + r0) * d_len;
  for (int k = threadIdx.x; k < nr * d_len; k += kThreads) {
    const int r = k / d_len, d = k - r * d_len;
    const int bin = s_bin[d];
    float mag = __int_as_float(0x7fc00000);  // NaN
    if (bin >= 0) {
      const float2* x = s_spec + r * loops + bin;
      float re = 0.0f, im = 0.0f;
      for (int a = 0; a < a_len; ++a) {
        const float2 s = x[a * stride], w = s_w[a * d_len + d];
        re = __fadd_rn(re, __fsub_rn(__fmul_rn(s.x, w.x), __fmul_rn(s.y, w.y)));
        im = __fadd_rn(im, __fadd_rn(__fmul_rn(s.x, w.y), __fmul_rn(s.y, w.x)));
      }
      mag = sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
    }
    __stcs(dst + k, mag);
  }
}

size_t granted[2][kMaxDevices];  // per instance and device: the shared memory granted

}  // namespace

// spec [frames, a_len, ns, loops] complex64 (float2), weights [a_len, d_len]
// complex64, bins [frames, d_len] int64, out [frames, ns, d_len] float32, all
// contiguous.  frames, ns, loops, d_len >= 1, 1 <= a_len <= kMaxAntennas, a
// block's shared memory within kMaxSharedBytes at one row a tile
// (8 (A rows L rounded up to even + A D) + 4 D bytes) and at most 2^31 - 1
// blocks, else cudaErrorInvalidValue and nothing launched.  Returns a
// cudaError_t as int.
extern "C" int dbs_pick(const void* spec, const void* weights, const long long* bins,
                        long long frames, int a_len, int ns, int loops, int d_len, float* out,
                        cudaStream_t stream) {
  if (frames < 1 || a_len < 1 || a_len > kMaxAntennas || ns < 1 || loops < 1 || d_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // rows a tile: about kTileBytes of spectrum, fewer where the weights leave
  // no room, then balanced over the frame's tiles (which only lowers them)
  const long long row_bytes = static_cast<long long>(sizeof(float2)) * a_len * loops;
  long long rows = kTileBytes / row_bytes;
  rows = rows < 1 ? 1 : (rows > ns ? ns : rows);
  while (rows > 1 && shared_bytes(a_len, static_cast<int>(rows), loops, d_len)
                         > static_cast<size_t>(kMaxSharedBytes)) {
    --rows;
  }
  const long long row_tiles = (ns + rows - 1) / rows;
  rows = (ns + row_tiles - 1) / row_tiles;
  const size_t smem = shared_bytes(a_len, static_cast<int>(rows), loops, d_len);
  if (smem > static_cast<size_t>(kMaxSharedBytes) || frames > 0x7fffffffLL / row_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(frames * row_tiles);
  const bool vec = loops % 2 == 0 && (reinterpret_cast<uintptr_t>(spec) & 15) == 0;
  auto kernel = vec ? &dbs_pick_kernel<true> : &dbs_pick_kernel<false>;
  const int err = grant_dynamic_shared(kernel, smem, granted[vec ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float2*>(spec), static_cast<const float2*>(weights), bins, a_len, ns,
      loops, d_len, static_cast<int>(rows), static_cast<int>(row_tiles), out);
  return static_cast<int>(cudaGetLastError());
}
