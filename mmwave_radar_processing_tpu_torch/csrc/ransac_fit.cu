// The fixed-trial RANSAC fit on Hopper (sm_90a): for each fit of a batch, every
// trial's sample, its ridged least-squares solve, its inliers and R^2, the
// winner, and the refit on the winner's inliers, in one launch.
//
// Replaces no TPU kernel: the JAX package's
//   mmwave_radar_processing_tpu/ops/ransac.py :: ransac_linear
// is plain jnp, and the port carried it over as some ninety batched PyTorch
// operations over [..., trials, N] (ops/ransac.py ::
// ransac_linear_reference, the plain version): a -inf mask, torch.topk, a
// batched GEMM and torch.linalg.solve_ex, a GEMV of the predictions, masked
// reductions, a float32 key, argmax, a gather and the refit again, each
// intermediate a round trip through device memory.
//
// The function, on each fit (h [N, D], y [N], valid [N], scores [T, N],
// threshold thr, k = min(min_samples, N)), as the plain version computes it:
//   sample     the valid rows whose score is at least the k-th largest valid
//              score, ties all sampled; -inf (every valid row) with fewer
//              than k valid rows;
//   solve      A = sum h h^T, b = sum h y over the sample; ridge
//              1e-7 (trace(A) / D + 1e-30) on the diagonal; D = 1 divides,
//              D = 2, 3 eliminate with partial pivoting, as LU does;
//   inliers    valid rows with |y - h.c| <= thr;
//   R^2        over the inliers: their mean first, then ss_res and ss_tot,
//              1 - ss_res / ss_tot, 0 where ss_tot is not positive;
//   winner     the first maximum of the float32 n_in * 1e6 + R^2 + t * 1e-9,
//              evaluated in that order (a NaN counts as the largest, as in
//              torch.argmax);
//   refit      the solve on the winner's inliers; R^2 on them where there
//              are more than 3, else 0; fraction n_in / n_valid (0 with no
//              valid row); ok = n_valid >= min_samples; coef, R^2 and the
//              fraction 0 and the mask false where ok is false.
// Comparisons and selections are exact; the sums run in another order than
// torch's, so coefficients and R^2 differ from the plain version's by
// rounding, and a residual within rounding of the threshold may flip.
//
// What bounds it: bytes.  A fit reads its valid flags (N bytes) and, of its
// valid rows only, h, y and the T scores: 4 (D + 1 + T) bytes a valid row
// (96 at D = 3, T = 20); it writes D + 2 floats, N + 1 bytes.  The flight of
// the velocity-analysis cell (4096 fits of N = 512, D = 3, ~100 valid rows)
// reads about 42 MB: 0.013 ms at 3.35 TB/s.  Its arithmetic, a few thousand
// operations a trial, is nothing at 67 TFLOP/s; what a fit costs is latency.
// The design keeps a fit on one SM and every intermediate on chip:
//   1. one block a fit, one warp a trial (T warps, T <= kMaxTrials);
//   2. the block ballots the valid flags into one word a chunk of 32 rows,
//      then every warp walks the chunks with a running prefix count and
//      compacts its trial's valid scores into shared memory; the warps
//      share the copy of the valid rows of h and y.  Only valid rows' data
//      is read;
//   3. each warp: the k-th largest score by rounds of warp-wide maxima over
//      the values below the last round's (each round counts the ties, so a
//      round can settle several of the k); the sample's sums by shuffles;
//      the solve in registers (every lane the same); one pass for the
//      residuals, the inliers (a ballot word a chunk, kept in shared
//      memory) and ss_res, a second for ss_tot; the key to shared memory;
//   4. every warp takes the first maximum of the T keys; warp 0 refits on
//      the winner's inlier words and writes coef, R^2, the fraction and ok,
//      while the block writes the inlier mask in the rows' own order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_helpers.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxTrials = 32;    // a warp a trial: at most 1024 threads a block
constexpr int kMaxFeatures = 3;   // D: instances 1, 2 and 3
constexpr int kMaxRows = 2048;    // N: a lane keeps one inlier bit a chunk in 64 bits
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int row_chunks(int n) { return (n + kWarp - 1) / kWarp; }

// 4-byte words of a block's shared memory: the valid words and the chunks'
// first compacted rows (a chunk each), the compacted h (D columns) and y, the
// compacted scores (a row a trial), the inlier words (a row a trial), the keys.
__host__ __forceinline__ size_t shared_bytes(int n, int d, int trials) {
  const size_t c = static_cast<size_t>(row_chunks(n));
  return 4 * (2 * c + static_cast<size_t>(d + 1 + trials) * n + trials * c + trials);
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane adds the same pairs (a + b == b + a), so all agree
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The k-th largest of s[0..n) with ties counted (torch.topk's values[k - 1]);
// -inf where n < k.  Round r finds the largest value below round r-1's and
// how many rows hold it.
__device__ float kth_largest(const float* s, int n, int k, int lane) {
  if (n < k) return -INFINITY;
  float bound = INFINITY;
  bool first = true;
  int need = k;
  for (;;) {
    float m = -INFINITY;
    int count = 0;
    bool any = false;
    for (int j = lane; j < n; j += kWarp) {
      const float v = s[j];
      if (first || v < bound) {
        if (!any || v > m) {
          m = v;
          count = 1;
          any = true;
        } else if (v == m) {
          ++count;
        }
      }
    }
    if (__ballot_sync(kFull, any) == 0) return -INFINITY;  // only NaN left
    float top = any ? m : -INFINITY;
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) top = fmaxf(top, __shfl_xor_sync(kFull, top, o));
    need -= warp_sum(any && m == top ? count : 0);
    if (need <= 0) return top;
    bound = top;
    first = false;
  }
}

// The sums of the normal equations over the rows of the compacted columns hs
// (column d at hs + d * stride) and ys for which take(j) holds, every lane
// the warp's total: a[r][c] for c >= r, mirrored, and b.
template <int D, class Take>
__device__ __forceinline__ void normal_equations(const float* hs, int stride, const float* ys,
                                                 int nv, int lane, Take take, float (&a)[D][D],
                                                 float (&b)[D]) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    b[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < D; ++c) a[r][c] = 0.0f;
  }
  for (int j = lane; j < nv; j += kWarp) {
    if (!take(j)) continue;
    float hj[D];
#pragma unroll
    for (int d = 0; d < D; ++d) hj[d] = hs[d * stride + j];
    const float yj = ys[j];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      b[r] = fmaf(hj[r], yj, b[r]);
#pragma unroll
      for (int c = r; c < D; ++c) a[r][c] = fmaf(hj[r], hj[c], a[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < D; ++r) {
    b[r] = warp_sum(b[r]);
#pragma unroll
    for (int c = r; c < D; ++c) a[r][c] = warp_sum(a[r][c]);
#pragma unroll
    for (int c = 0; c < r; ++c) a[r][c] = a[c][r];
  }
}

// (A + ridge I) c = b with the ridge 1e-7 (trace / D + 1e-30); A and b are
// overwritten.  The pivot of a column is its first largest |value| at or
// below the diagonal; every index is a constant after unrolling, so the
// system stays in registers.
template <int D>
__device__ __forceinline__ void solve_ridged(float (&a)[D][D], float (&b)[D], float (&c)[D]) {
  float trace = a[0][0];
#pragma unroll
  for (int i = 1; i < D; ++i) trace = __fadd_rn(trace, a[i][i]);
  const float ridge = __fmul_rn(1e-7f, __fadd_rn(__fdiv_rn(trace, static_cast<float>(D)), 1e-30f));
#pragma unroll
  for (int i = 0; i < D; ++i) a[i][i] = __fadd_rn(a[i][i], ridge);
  if constexpr (D == 1) {
    c[0] = __fdiv_rn(b[0], a[0][0]);
    return;
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    int p = j;
    float best = fabsf(a[j][j]);
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      if (fabsf(a[i][j]) > best) {
        best = fabsf(a[i][j]);
        p = i;
      }
    }
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      if (i == p) {
#pragma unroll
        for (int q = 0; q < D; ++q) {
          const float t = a[i][q];
          a[i][q] = a[j][q];
          a[j][q] = t;
        }
        const float t = b[i];
        b[i] = b[j];
        b[j] = t;
      }
    }
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      const float l = __fdiv_rn(a[i][j], a[j][j]);
#pragma unroll
      for (int q = j + 1; q < D; ++q) a[i][q] = fmaf(-l, a[j][q], a[i][q]);
      b[i] = fmaf(-l, b[j], b[i]);
    }
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float r = b[i];
#pragma unroll
    for (int q = i + 1; q < D; ++q) r = fmaf(-a[i][q], c[q], r);
    c[i] = __fdiv_rn(r, a[i][i]);
  }
}

template <int D>
__device__ __forceinline__ float predict(const float* hs, int stride, int j, const float (&c)[D]) {
  float p = __fmul_rn(hs[j], c[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) p = fmaf(hs[d * stride + j], c[d], p);
  return p;
}

// R^2 from the inliers' count, sum of y and ss_res, and ss_tot about their mean.
__device__ __forceinline__ float r_squared(float ss_res, float ss_tot) {
  return ss_tot > 0.0f ? __fsub_rn(1.0f, __fdiv_rn(ss_res, ss_tot)) : 0.0f;
}

// Whether key a at trial ia comes before key b at trial ib in torch.argmax's
// order: the larger, a NaN above all, the lower trial among equals.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

template <int D>
__global__ void __launch_bounds__(kMaxTrials * kWarp)
ransac_fit_kernel(const float* __restrict__ h, const float* __restrict__ y,
                  const unsigned char* __restrict__ valid, const float* __restrict__ scores,
                  const float* __restrict__ thr_per_fit, float thr_all, int n, int trials, int k,
                  int min_samples, float* __restrict__ coef, float* __restrict__ r2_out,
                  float* __restrict__ fraction_out, unsigned char* __restrict__ mask_out,
                  unsigned char* __restrict__ ok_out) {
  extern __shared__ unsigned words[];
  const int chunks = row_chunks(n);
  unsigned* vbits = words;                                   // [chunks]
  int* first_row = reinterpret_cast<int*>(vbits + chunks);   // [chunks]
  float* hs = reinterpret_cast<float*>(first_row + chunks);  // [D][n]
  float* ys = hs + D * n;                                    // [n]
  float* ss = ys + n;                                        // [trials][n]
  unsigned* ibits = reinterpret_cast<unsigned*>(ss + static_cast<size_t>(trials) * n);
  float* keys = reinterpret_cast<float*>(ibits + trials * chunks);  // [trials]

  const long long fit = blockIdx.x;
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const long long row0 = fit * n;

  // 1. the valid flags, a ballot word a chunk
  for (int c = warp; c < chunks; c += trials) {
    const int i = c * kWarp + lane;
    const bool v = i < n && valid[row0 + i] != 0;
    const unsigned word = __ballot_sync(kFull, v);
    if (lane == 0) vbits[c] = word;
  }
  __syncthreads();

  // 2. compaction: warp t copies its trial's valid scores, and the chunks
  //    c = t mod T of h and y; every warp counts the valid rows itself
  const float* s_row = scores + (fit * trials + warp) * n;
  float* s_dst = ss + static_cast<size_t>(warp) * n;
  const unsigned below = (1u << lane) - 1u;
  int nv = 0;
#pragma unroll 4
  for (int c = 0; c < chunks; ++c) {
    const unsigned word = vbits[c];
    if (warp == 0 && lane == 0) first_row[c] = nv;
    if ((word >> lane) & 1u) {
      const int i = c * kWarp + lane;
      const int p = nv + __popc(word & below);
      s_dst[p] = __ldcs(s_row + i);
      if (c % trials == warp) {
        ys[p] = __ldg(y + row0 + i);
#pragma unroll
        for (int d = 0; d < D; ++d) hs[d * n + p] = __ldg(h + (row0 + i) * D + d);
      }
    }
    nv += __popc(word);
  }
  __syncthreads();

  // 3. this warp's trial
  const int t = warp;
  const float thr = thr_per_fit != nullptr ? __ldg(thr_per_fit + fit) : thr_all;
  {
    const float* st = ss + static_cast<size_t>(t) * n;
    const float kth = kth_largest(st, nv, k, lane);
    float a[D][D], b[D], cf[D];
    normal_equations<D>(hs, n, ys, nv, lane, [&](int j) { return st[j] >= kth; }, a, b);
    solve_ridged<D>(a, b, cf);

    int n_in = 0;
    float sum_y = 0.0f, ss_res = 0.0f;
    unsigned long long mine = 0;  // bit c: this lane's row of chunk c is an inlier
    for (int c = 0; c * kWarp < nv; ++c) {
      const int j = c * kWarp + lane;
      bool in = false;
      if (j < nv) {
        const float yj = ys[j];
        const float r = __fsub_rn(yj, predict<D>(hs, n, j, cf));
        in = fabsf(r) <= thr;
        if (in) {
          sum_y = __fadd_rn(sum_y, yj);
          ss_res = fmaf(r, r, ss_res);
          mine |= 1ull << c;
        }
      }
      const unsigned word = __ballot_sync(kFull, in);
      if (lane == 0) ibits[t * chunks + c] = word;
      n_in += __popc(word);
    }
    sum_y = warp_sum(sum_y);
    ss_res = warp_sum(ss_res);
    const float mean = __fdiv_rn(sum_y, fmaxf(static_cast<float>(n_in), 1.0f));
    float ss_tot = 0.0f;
    for (int c = 0; c * kWarp < nv; ++c) {
      if ((mine >> c) & 1ull) {
        const float e = __fsub_rn(ys[c * kWarp + lane], mean);
        ss_tot = fmaf(e, e, ss_tot);
      }
    }
    ss_tot = warp_sum(ss_tot);
    if (lane == 0) {
      const float r2 = r_squared(ss_res, ss_tot);
      keys[t] = __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(n_in), 1e6f), r2),
                          __fmul_rn(static_cast<float>(t), 1e-9f));
    }
  }
  __syncthreads();

  // 4. the winner, in every warp
  float key = lane < trials ? keys[lane] : -INFINITY;
  int best = lane < trials ? lane : kMaxTrials + lane;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(kFull, key, o);
    const int other_t = __shfl_xor_sync(kFull, best, o);
    if (before(other, other_t, key, best)) {
      key = other;
      best = other_t;
    }
  }
  const unsigned* win = ibits + best * chunks;
  const bool ok = nv >= min_samples;

  if (warp == 0) {
    float a[D][D], b[D], cf[D];
    normal_equations<D>(hs, n, ys, nv, lane,
                        [&](int j) { return ((win[j / kWarp] >> (j % kWarp)) & 1u) != 0; },
                        a, b);
    solve_ridged<D>(a, b, cf);
    int n_in = 0;
    float sum_y = 0.0f, ss_res = 0.0f;
    for (int c = 0; c * kWarp < nv; ++c) {
      const unsigned word = win[c];
      n_in += __popc(word);
      if ((word >> lane) & 1u) {
        const int j = c * kWarp + lane;
        const float yj = ys[j];
        const float r = __fsub_rn(yj, predict<D>(hs, n, j, cf));
        sum_y = __fadd_rn(sum_y, yj);
        ss_res = fmaf(r, r, ss_res);
      }
    }
    sum_y = warp_sum(sum_y);
    ss_res = warp_sum(ss_res);
    const float mean = __fdiv_rn(sum_y, fmaxf(static_cast<float>(n_in), 1.0f));
    float ss_tot = 0.0f;
    for (int c = 0; c * kWarp < nv; ++c) {
      if ((win[c] >> lane) & 1u) {
        const float e = __fsub_rn(ys[c * kWarp + lane], mean);
        ss_tot = fmaf(e, e, ss_tot);
      }
    }
    ss_tot = warp_sum(ss_tot);
    if (lane < D) {
      float v = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) v = d == lane ? cf[d] : v;
      coef[fit * D + lane] = ok ? v : 0.0f;
    }
    if (lane == 0) {
      const float r2 = n_in > 3 ? r_squared(ss_res, ss_tot) : 0.0f;
      const float fraction =
          nv > 0 ? __fdiv_rn(static_cast<float>(n_in), static_cast<float>(nv)) : 0.0f;
      r2_out[fit] = ok ? r2 : 0.0f;
      fraction_out[fit] = ok ? fraction : 0.0f;
      ok_out[fit] = ok ? 1 : 0;
    }
  }

  // the inlier mask in the rows' own order
  for (int i = static_cast<int>(threadIdx.x); i < n; i += trials * kWarp) {
    const int c = i / kWarp, bit = i % kWarp;
    const unsigned word = vbits[c];
    bool in = false;
    if (ok && ((word >> bit) & 1u)) {
      const int p = first_row[c] + __popc(word & ((1u << bit) - 1u));
      in = ((win[p / kWarp] >> (p % kWarp)) & 1u) != 0;
    }
    mask_out[row0 + i] = in ? 1 : 0;
  }
}

size_t granted[kMaxFeatures][kMaxDevices];  // per instance and device: the shared memory granted

}  // namespace

// h [fits, n, d], y and valid [fits, n] (float32, bool as bytes), scores
// [fits, trials, n] float32, thr [fits] float32 or null (then thr_value for
// every fit), all contiguous; coef [fits, d], r2 and fraction [fits] float32,
// mask [fits, n] and ok [fits] bytes.  1 <= fits <= 2^31 - 1,
// 1 <= n <= kMaxRows, 1 <= d <= kMaxFeatures, 1 <= trials <= kMaxTrials,
// 1 <= k <= n, min_samples >= 1 and the block's shared memory
// (4 (2 C + (d + 1 + trials) n + trials C + trials) bytes, C = ceil(n / 32))
// within kMaxSharedBytes, else cudaErrorInvalidValue and nothing launched.
// Returns a cudaError_t as int.
extern "C" int ransac_fit(const float* h, const float* y, const unsigned char* valid,
                          const float* scores, const float* thr, float thr_value,
                          long long fits, int n, int d, int trials, int k, int min_samples,
                          float* coef, float* r2, float* fraction, unsigned char* mask,
                          unsigned char* ok, cudaStream_t stream) {
  if (fits < 1 || fits > 0x7fffffffLL || n < 1 || n > kMaxRows || d < 1 || d > kMaxFeatures
      || trials < 1 || trials > kMaxTrials || k < 1 || k > n || min_samples < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes(n, d, trials);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = d == 1 ? &ransac_fit_kernel<1> : d == 2 ? &ransac_fit_kernel<2>
                                                        : &ransac_fit_kernel<3>;
  const int err = grant_dynamic_shared(kernel, smem, granted[d - 1]);
  if (err != 0) return err;
  kernel<<<static_cast<unsigned>(fits), trials * kWarp, smem, stream>>>(
      h, y, valid, scores, thr, thr_value, n, trials, k, min_samples, coef, r2, fraction, mask,
      ok);
  return static_cast<int>(cudaGetLastError());
}
