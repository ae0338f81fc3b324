// The synthetic-aperture steering phases on Hopper (sm_90a):
//   out[t, a, e] = exp(j * 2*pi * (d_a . p_t[:, e]) / lambda)
// over steering vectors d [A, 3] and element positions p [T, 3, E], complex64.
//
// Replaces no TPU kernel: the JAX package computes the phases as plain jnp
// (mmwave_radar_processing_tpu/processors/synthetic_array.py:68 and
// parallel/beamform_pipeline.py:92).  The port first carried them over as
// four passes (processors/synthetic_array.py :: steering_phases_reference,
// the plain version): a K = 3 GEMM that writes float32 angles, two in-place
// scalings and torch.polar.  At the RadSAR cell's [1024, 960, 800] those
// passes move 25.2 GB a call (the angles written, read and written twice,
// read once more; the phases written), a third of the cell's device time.
//
// The arithmetic, in float32 and in the plain version's order on CUDA:
//   dot   = d0*p0, then fma(d1, p1, dot), then fma(d2, p2, dot) (a GEMM's
//           inner loop over K = 3);
//   angle = (dot * float32(2*pi)) * float32(1 / float32(lambda)), two
//           roundings: PyTorch's in-place multiply, then its division by a
//           scalar, which it runs on CUDA as a multiply by the reciprocal;
//   out   = (cos angle, sin angle) from the accurate sincosf.
// Angles reach some 500 rad (a 0.3 m aperture over a 3.9 mm wavelength),
// far outside the range where the fast __sincosf is accurate, so no fast
// math: the build passes no --use_fast_math, and the source calls sincosf.
//
// What bounds it: bytes written.  The inputs are small (the steering vectors
// 12 B a direction, the positions 12 B an element a frame: 9.8 MB at
// [1024, 3, 800]); the output is 8 B a phase, 6.29 GB at [1024, 960, 800]:
// 1.88 ms at 3.35 TB/s.  The sincosf of every phase (some 30-40
// instructions in the range these angles take) costs about 1 ms of issue
// across 132 SMs and has to hide under the stores.  The design:
//   1. a block takes one frame, a tile of kRows directions and a tile of up
//      to kTileE elements; blocks of one frame's tiles of directions are
//      consecutive, so they read its positions from L2;
//   2. the block stages the tile's 3 x ne positions in shared memory once
//      (9.6 KB at E = 800);
//   3. a warp takes one direction at a time, its steering vector in
//      registers, and walks the row along E: each lane forms two adjacent
//      phases and writes them as one 16-byte streaming store, so a warp
//      writes 512 contiguous bytes a step (an odd E, or an output off 16
//      bytes, takes 8-byte stores of one phase);
//   4. nothing else touches device memory: the angles never leave registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;      // directions a block: kRows / kWarps rows a warp
constexpr int kTileE = 2048;   // elements a block: 24 KB of positions in shared memory

__device__ __forceinline__ float phase_angle(float dx, float dy, float dz, float x, float y,
                                             float z, float two_pi, float inv_lambda) {
  float dot = __fmul_rn(dx, x);
  dot = __fmaf_rn(dy, y, dot);
  dot = __fmaf_rn(dz, z, dot);
  return __fmul_rn(__fmul_rn(dot, two_pi), inv_lambda);
}

// kPairs: E is even and out 16-byte aligned, so every row starts on 16
// bytes and holds whole pairs of phases.
template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
steering_phases_kernel(const float* __restrict__ steering, const float* __restrict__ positions,
                       int a_len, int e_len, int a_tiles, int e_tiles, float two_pi,
                       float inv_lambda, float2* __restrict__ out) {
  extern __shared__ float4 stage4[];
  const long long block = blockIdx.x;
  const int a_tile = static_cast<int>(block % a_tiles);
  const long long rest = block / a_tiles;
  const int e0 = static_cast<int>(rest % e_tiles) * kTileE;
  const long long t = rest / e_tiles;
  const int ne = e_len - e0 < kTileE ? e_len - e0 : kTileE;

  float* px = reinterpret_cast<float*>(stage4);
  float* py = px + ne;
  float* pz = py + ne;
  const float* src = positions + t * 3 * e_len + e0;
  for (int k = threadIdx.x; k < ne; k += kThreads) {
    px[k] = __ldg(src + k);
    py[k] = __ldg(src + e_len + k);
    pz[k] = __ldg(src + 2 * static_cast<long long>(e_len) + k);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int a_end = (a_tile + 1) * kRows < a_len ? (a_tile + 1) * kRows : a_len;
  for (int a = a_tile * kRows + warp; a < a_end; a += kWarps) {
    const float* d = steering + 3 * static_cast<long long>(a);
    const float dx = __ldg(d), dy = __ldg(d + 1), dz = __ldg(d + 2);
    float2* row = out + (t * a_len + a) * e_len + e0;
    if constexpr (kPairs) {
      const float2* px2 = reinterpret_cast<const float2*>(px);
      const float2* py2 = reinterpret_cast<const float2*>(py);
      const float2* pz2 = reinterpret_cast<const float2*>(pz);
      float4* row4 = reinterpret_cast<float4*>(row);
      for (int j = lane; j < (ne >> 1); j += 32) {
        const float2 x = px2[j], y = py2[j], z = pz2[j];
        float s0, c0, s1, c1;
        sincosf(phase_angle(dx, dy, dz, x.x, y.x, z.x, two_pi, inv_lambda), &s0, &c0);
        sincosf(phase_angle(dx, dy, dz, x.y, y.y, z.y, two_pi, inv_lambda), &s1, &c1);
        __stcs(row4 + j, make_float4(c0, s0, c1, s1));
      }
    } else {
      for (int e = lane; e < ne; e += 32) {
        float s, c;
        sincosf(phase_angle(dx, dy, dz, px[e], py[e], pz[e], two_pi, inv_lambda), &s, &c);
        __stcs(row + e, make_float2(c, s));
      }
    }
  }
}

}  // namespace

// steering [a_len, 3], positions [frames, 3, e_len] float32, out [frames,
// a_len, e_len] complex64 (float2), all contiguous; two_pi and inv_lambda
// the two float32 factors of the angle.  frames, a_len, e_len >= 1 and at
// most 2^31 - 1 blocks, else cudaErrorInvalidValue and nothing launched.
// Returns a cudaError_t as int.
extern "C" int steering_phases(const float* steering, const float* positions, long long frames,
                               int a_len, int e_len, float two_pi, float inv_lambda, void* out,
                               cudaStream_t stream) {
  if (frames < 1 || a_len < 1 || e_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long a_tiles = (a_len + kRows - 1) / kRows;
  const long long e_tiles = (e_len + kTileE - 1) / kTileE;
  if (frames > 0x7fffffffLL / (a_tiles * e_tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(frames * a_tiles * e_tiles);
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(e_len < kTileE ? e_len : kTileE);
  const bool pairs = e_len % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  float2* dst = static_cast<float2*>(out);
  if (pairs) {
    steering_phases_kernel<true><<<blocks, kThreads, smem, stream>>>(
        steering, positions, a_len, e_len, static_cast<int>(a_tiles),
        static_cast<int>(e_tiles), two_pi, inv_lambda, dst);
  } else {
    steering_phases_kernel<false><<<blocks, kThreads, smem, stream>>>(
        steering, positions, a_len, e_len, static_cast<int>(a_tiles),
        static_cast<int>(e_tiles), two_pi, inv_lambda, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
