// The velocity peak picker on Hopper (sm_90a): for each row of [rows, N], the
// highest strict local maximum whose topographic prominence reaches a floor.
//
// Replaces no TPU kernel: the JAX package's
//   mmwave_radar_processing_tpu/ops/peaks.py :: best_prominent_peak
// is plain jnp (pairwise [M, N] masks under vmap, shaped for the TPU's vector
// unit), and the port first carried it over as the same masks
// (ops/peaks.py :: best_prominent_peak_reference, the plain version).  On the
// H100 that form took 69% of the device time of the flagship benchmark cell
// (ods20-combined-bulk: 13.9 of 20.2 ms a batch of 1024 frames): a sort and
// some ten elementwise and reduction kernels over [rows, 30, 60]
// intermediates of about 1 GB each.
//
// The function, on each row x[0..N):
//   peak i       0 < i < N-1 and x[i-1] < x[i] > x[i+1] (a NaN compares false);
//   its bases    left: the minimum of x[j] for j from i down to, but not
//                including, the nearest j < i with x[j] > x[i], or down to 0;
//                right: the same to the right, up to N-1;
//   prominence   x[i] - max(left, right), one float32 subtraction; a NaN in
//                either range makes it NaN (torch.amin and torch.maximum
//                propagate NaN, where fminf and fmaxf would drop it);
//   passes       x[i] is finite and its prominence >= min_prominence;
//   result       the passing peak of highest value, ties (compared as floats,
//                so -0.0 ties with 0.0) to the lowest index; index 0 and found
//                false where no peak passes.
// Compares, minima, maxima and one subtraction: the result equals the plain
// version's bit for bit.
//
// What bounds it: bytes.  At the velocity path's [1024, 2, 70, 60] (143,360
// rows of 60) it reads 34.4 MB and writes 1.29 MB (an int64 and a bool a row):
// 10.7 us at 3.35 TB/s.  The compares are 2 a sample for the maxima and, for
// the walks, O(N^2) a row at worst (every peak walking to the row's ends):
// under 2,000 a row at N = 60, nothing at 67 TFLOP/s.  The design:
//   1. a block of kWarps warps takes kWarps consecutive rows, one contiguous
//      run of kWarps * N floats, and loads it into shared memory with 16-byte
//      loads where the run is 16-byte aligned (neighbouring threads on
//      neighbouring addresses), else 4-byte loads;
//   2. one warp a row: each lane tests its samples (lane + 1, lane + 33, ...)
//      for a local maximum and, for a peak that could still beat the lane's
//      best, walks outwards in shared memory keeping a running minimum, up to
//      a higher sample or the row's end;
//   3. a shuffle reduction over the warp on (value, index, passes) picks the
//      winner, and lane 0 writes it.  Nothing but the result touches device
//      memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 1024;  // kWarps rows of kMaxN floats: 32 KB of shared memory

// Whether the peak x[i] = v of `row` passes: finite, no NaN in its bases, and
// a prominence of at least min_prom.
__device__ __forceinline__ bool passes(const float* row, int n, int i, float v,
                                       float min_prom) {
  if (!isfinite(v)) return false;
  bool nan = false;
  float left = v;
  for (int j = i - 1; j >= 0; --j) {
    const float y = row[j];
    if (y > v) break;
    left = fminf(left, y);
    nan |= isnan(y);
  }
  float right = v;
  for (int j = i + 1; j < n; ++j) {
    const float y = row[j];
    if (y > v) break;
    right = fminf(right, y);
    nan |= isnan(y);
  }
  return !nan && __fsub_rn(v, fmaxf(left, right)) >= min_prom;
}

__global__ void __launch_bounds__(kThreads)
prominent_peak_kernel(const float* __restrict__ x, long long rows, int n, float min_prom,
                      long long* __restrict__ index, uint8_t* __restrict__ found) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const long long r0 = static_cast<long long>(blockIdx.x) * kWarps;
  const int nr = static_cast<int>(rows - r0 < kWarps ? rows - r0 : kWarps);
  const float* src = x + r0 * n;
  const int count = nr * n;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int count4 = count >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int k = threadIdx.x; k < count4; k += kThreads) stage4[k] = __ldg(src4 + k);
    for (int k = (count4 << 2) + threadIdx.x; k < count; k += kThreads) {
      stage[k] = __ldg(src + k);
    }
  } else {
    for (int k = threadIdx.x; k < count; k += kThreads) stage[k] = __ldg(src + k);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nr) return;  // the whole warp: the last block's missing rows
  const float* row = stage + warp * n;
  float best = -INFINITY;
  int best_i = 0;
  bool any = false;
  for (int i = lane + 1; i < n - 1; i += 32) {
    const float v = row[i];
    if (!(row[i - 1] < v && v > row[i + 1])) continue;
    // this lane's later samples have higher indices: an equal value loses
    if (any && !(v > best)) continue;
    if (passes(row, n, i, v, min_prom)) {
      best = v;
      best_i = i;
      any = true;
    }
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other = __shfl_down_sync(0xffffffffu, best, offset);
    const int other_i = __shfl_down_sync(0xffffffffu, best_i, offset);
    const bool other_any = __shfl_down_sync(0xffffffffu, static_cast<int>(any), offset) != 0;
    if (other_any && (!any || other > best || (other == best && other_i < best_i))) {
      best = other;
      best_i = other_i;
      any = true;
    }
  }
  if (lane == 0) {
    index[r0 + warp] = any ? best_i : 0;
    found[r0 + warp] = any ? 1 : 0;
  }
}

}  // namespace

// x [rows, n] float32, contiguous; index [rows] int64, found [rows] one byte
// each.  rows >= 1, 1 <= n <= kMaxN, else cudaErrorInvalidValue and nothing
// launched.  Returns a cudaError_t as int.
extern "C" int prominent_peak(const float* x, long long rows, int n, float min_prom,
                              long long* index, uint8_t* found, cudaStream_t stream) {
  const long long blocks = rows < 1 ? 0 : (rows + kWarps - 1) / kWarps;
  if (blocks < 1 || blocks > 0x7fffffffLL || n < 1 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * kWarps * static_cast<size_t>(n);
  prominent_peak_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, rows, n, min_prom, index, found);
  return static_cast<int>(cudaGetLastError());
}
