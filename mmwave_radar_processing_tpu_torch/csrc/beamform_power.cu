// Capon (MVDR) and Bartlett power maps of antenna snapshots, for Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package:
//   ops/pallas/capon.py     capon_power_pallas          (Capon),
//   ops/pallas/capon.py     bartlett_power_pallas_cov   (Bartlett, covariance pairs),
//   ops/pallas/beamform.py  bartlett_power              (Bartlett, from snapshot blocks).
// The last two compute one quantity, mean_k |a^H x_k|^2 = a^H R a; the snapshot
// blocks [N, A, K] of the third are [N, A, 1, K] in this kernel's layout.
//
// Input x: complex64 [B, A, W, K] (frames, antennas, range bins, chirps), read in
// place as interleaved (re, im) float pairs; steering a: complex64 (A, M).
// Output: float32 [B, W, M].  For each frame b and range bin w:
//
//   R      = X X^H / K                       X = x[b, :, w, :]  (A x K)
//   Capon:    R' = R + (loading * tr(R) / A + 1e-12) I = L L^H (complex Cholesky)
//             P_m = 1 / max(||L^-1 a_m||^2, tiny)
//   Bartlett: P_m = sum_i |a_im|^2 r_ii + 2 sum_{i>j} Re(r_ij conj(a_im) a_jm)
//
// The Cholesky diagonal is sqrt(max(s, tiny)) as in the JAX package.  The plain
// PyTorch versions are ops/beamform.py capon_power_reference and
// bartlett_power_reference; the sums run in another order here (lanes over
// chirps, then a shuffle tree), so results agree to float32 rounding, not bit
// for bit.
//
// Design: one warp per (frame, range bin), four warps per block, A a template
// parameter (1..16) so every loop over antennas unrolls.
//  1. Covariance: the lanes stride over the K chirps, so each load of an
//     antenna's samples is one coalesced 256-byte run along K.  Row by row of
//     the lower triangle, each lane accumulates its partial sums in registers,
//     a shuffle tree reduces them, and lane 0 writes R to shared memory.
//  2. Capon: diagonal loading, then the Cholesky factor column by column with
//     the lanes over rows, then L^-1 with the lanes over columns (forward
//     substitution on the identity), all in the warp's shared memory.
//  3. The lanes stride over the M angles: each reads a_m, forms g = L^-1 a_m
//     (or the Bartlett quadratic form from R), and the warp stores one
//     contiguous row of M powers.
// The TPU layout (frames blocked per grid step, range bins on sublanes,
// precomputed angle-pair constants) is not carried over.
//
// Bound: at the flagship shape (B = 1024, A = 4, W = 63, K = 70, M = 64) the
// kernel reads 144 MB and writes 16.5 MB, ~50 us at the card's 3.35 TB/s; its
// arithmetic is ~0.5 G flops.  It is bound by memory and by the latency of each
// warp's short serial chain (covariance reduction, factorisation), which the
// 64k independent warps hide.
//
// Built by nvcc into a shared library with a plain C entry point, loaded with
// ctypes (mmwave_radar_processing_tpu_torch/ops/kernels/_build.py).

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxAntennas = 16;
constexpr float kTiny = FLT_MIN;  // jnp.finfo(float32).tiny
constexpr unsigned kFullMask = 0xffffffffu;

struct Args {
  const float2* x;
  const float2* steer;
  float* out;
  int rows;  // B * W
  int w_len;
  int k_len;
  int m_len;
  float loading;
  float inv_k;
  cudaStream_t stream;
};

// a * conj(b)
__device__ __forceinline__ float2 mul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// Lower triangle and diagonal of R = X X^H / K into cov[i*A + j], j <= i.
// xb points at antenna 0, chirp 0 of this (frame, range bin); antennas are
// a_stride apart.
template <int A>
__device__ void covariance(const float2* __restrict__ xb, long long a_stride,
                           int k_len, float inv_k, float2* cov, int lane) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float2 acc[A];
#pragma unroll
    for (int j = 0; j < A; ++j) acc[j] = make_float2(0.0f, 0.0f);
    for (int k = lane; k < k_len; k += 32) {
      const float2 xi = xb[i * a_stride + k];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const float2 p = mul_conj(xi, j == i ? xi : xb[j * a_stride + k]);
        acc[j].x += p.x;
        acc[j].y += p.y;
      }
    }
#pragma unroll
    for (int j = 0; j <= i; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[j].x += __shfl_xor_sync(kFullMask, acc[j].x, off);
        acc[j].y += __shfl_xor_sync(kFullMask, acc[j].y, off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        cov[i * A + j] = make_float2(acc[j].x * inv_k, acc[j].y * inv_k);
    }
  }
  __syncwarp();
}

// Loaded Cholesky factor lo (lower) of cov, and inv = lo^-1 (lower).
template <int A>
__device__ void cholesky_inverse(float2* cov, float loading, float2* lo,
                                 float2* inv, int lane) {
  if (lane == 0) {
    float tr = 0.0f;
#pragma unroll
    for (int i = 0; i < A; ++i) tr += cov[i * A + i].x;
    const float load = loading * tr / A + 1e-12f;
#pragma unroll
    for (int i = 0; i < A; ++i) cov[i * A + i].x += load;
  }
  __syncwarp();
  // column j: every lane forms the diagonal d (the same reads, the same
  // value), lane i > j its row's entry; step j reads columns < j only
#pragma unroll
  for (int j = 0; j < A; ++j) {
    float s = cov[j * A + j].x;
    for (int k = 0; k < j; ++k) {
      const float2 l = lo[j * A + k];
      s -= l.x * l.x + l.y * l.y;
    }
    const float d = sqrtf(fmaxf(s, kTiny));
    if (lane > j && lane < A) {
      float2 t = cov[lane * A + j];
      for (int k = 0; k < j; ++k) {
        const float2 p = mul_conj(lo[lane * A + k], lo[j * A + k]);
        t.x -= p.x;
        t.y -= p.y;
      }
      const float inv_d = 1.0f / d;
      lo[lane * A + j] = make_float2(t.x * inv_d, t.y * inv_d);
    }
    if (lane == j) lo[j * A + j] = make_float2(d, 0.0f);
    __syncwarp();
  }
  // L^-1 by forward substitution on the identity: lane j owns column j
  if (lane < A) {
    const int j = lane;
    const float vjj = 1.0f / lo[j * A + j].x;
    inv[j * A + j] = make_float2(vjj, 0.0f);
    for (int i = j + 1; i < A; ++i) {
      const float2 lij = lo[i * A + j];
      float2 s = make_float2(lij.x * vjj, lij.y * vjj);
      for (int k = j + 1; k < i; ++k) {
        const float2 l = lo[i * A + k];
        const float2 v = inv[k * A + j];
        s.x += l.x * v.x - l.y * v.y;
        s.y += l.x * v.y + l.y * v.x;
      }
      const float neg_inv_d = -1.0f / lo[i * A + i].x;
      inv[i * A + j] = make_float2(s.x * neg_inv_d, s.y * neg_inv_d);
    }
  }
  __syncwarp();
}

template <int A, bool kCapon>
__global__ void __launch_bounds__(kThreads) beamform_kernel(const Args args) {
  __shared__ float2 s_cov[kWarps][A * A];
  __shared__ float2 s_lo[kWarps][kCapon ? A * A : 1];
  __shared__ float2 s_inv[kWarps][kCapon ? A * A : 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= args.rows) return;  // the whole warp leaves; no block barrier below
  const long long b = row / args.w_len;
  const long long w = row % args.w_len;
  const long long a_stride = static_cast<long long>(args.w_len) * args.k_len;
  const float2* xb = args.x + (b * A * args.w_len + w) * args.k_len;
  float2* cov = s_cov[warp];
  covariance<A>(xb, a_stride, args.k_len, args.inv_k, cov, lane);

  const float2* inv = nullptr;
  if constexpr (kCapon) {
    cholesky_inverse<A>(cov, args.loading, s_lo[warp], s_inv[warp], lane);
    inv = s_inv[warp];
  }
  const int m_len = args.m_len;
  float* out_row = args.out + row * m_len;
  for (int m = lane; m < m_len; m += 32) {
    float2 a[A];
#pragma unroll
    for (int j = 0; j < A; ++j) a[j] = args.steer[static_cast<long long>(j) * m_len + m];
    float p = 0.0f;
    if constexpr (kCapon) {
#pragma unroll
      for (int i = 0; i < A; ++i) {
        float2 g = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          const float2 v = inv[i * A + j];
          g.x += v.x * a[j].x - v.y * a[j].y;
          g.y += v.x * a[j].y + v.y * a[j].x;
        }
        p += g.x * g.x + g.y * g.y;
      }
      p = 1.0f / fmaxf(p, kTiny);
    } else {
#pragma unroll
      for (int i = 0; i < A; ++i) {
        p += (a[i].x * a[i].x + a[i].y * a[i].y) * cov[i * A + i].x;
#pragma unroll
        for (int j = 0; j < i; ++j) {
          const float2 c = mul_conj(a[j], a[i]);  // conj(a_i) a_j
          const float2 r = cov[i * A + j];
          p += 2.0f * (r.x * c.x - r.y * c.y);
        }
      }
    }
    out_row[m] = p;
  }
}

template <bool kCapon, int A = 1>
int dispatch(int n_ant, const Args& args) {
  if constexpr (A > kMaxAntennas) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (n_ant != A) return dispatch<kCapon, A + 1>(n_ant, args);
    const long long blocks = (static_cast<long long>(args.rows) + kWarps - 1) / kWarps;
    beamform_kernel<A, kCapon>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, args.stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
}

template <bool kCapon>
int run(const void* x, const void* steer, void* out, int rows, int n_ant,
        int w_len, int k_len, int m_len, float loading, void* stream) {
  if (rows <= 0 || m_len <= 0) return 0;
  if (n_ant < 1 || n_ant > kMaxAntennas || w_len < 1 || k_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args = {static_cast<const float2*>(x), static_cast<const float2*>(steer),
                     static_cast<float*>(out), rows, w_len, k_len, m_len, loading,
                     1.0f / static_cast<float>(k_len), static_cast<cudaStream_t>(stream)};
  return dispatch<kCapon>(n_ant, args);
}

}  // namespace

// x: complex64 [rows / w_len, n_ant, w_len, k_len]; steer: complex64 [n_ant, m_len];
// out: float32 [rows, m_len].  All contiguous, on the device.  Launch on
// `stream`; return cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for n_ant outside 1..16.
extern "C" int capon_power(const void* x, const void* steer, void* out, int rows,
                           int n_ant, int w_len, int k_len, int m_len,
                           float loading, void* stream) {
  return run<true>(x, steer, out, rows, n_ant, w_len, k_len, m_len, loading, stream);
}

extern "C" int bartlett_power(const void* x, const void* steer, void* out, int rows,
                              int n_ant, int w_len, int k_len, int m_len,
                              float loading, void* stream) {
  return run<false>(x, steer, out, rows, n_ant, w_len, k_len, m_len, loading, stream);
}
