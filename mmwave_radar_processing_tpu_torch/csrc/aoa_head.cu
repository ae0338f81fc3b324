// The point-cloud angle head on Hopper (sm_90a): each filled detection slot's
// range-Doppler value on every channel the angles use, the zero-padded angle
// DFT of each subset, its argmax bin, and the FLU point, in one pass:
//   u[c]  = sum_{l < L} R[b, ch[c], r, l] * dop[l, v]      (r, v: the slot's bins)
//   az    = angle_bins[argmax_m |sum_a u[az[a]] * az_dft[a, m]|^2]   (0 if no az)
//   el    = the same over el, el_dft                                 (0 if no el)
//   out[b, k] = (r dr cos(el) cos(az), r dr cos(el) sin(az), r dr sin(el), v0 + v dv)
// over R complex64 [B, C, W, L] (its inner three dims contiguous, any batch
// stride: the head's R[:, start:] view is read in place), the Doppler matrix
// dop complex64 [L, V] (any strides), r_idx, v_idx int64 [B, K] and valid bool
// [B, K]; out float32 [B, K, 4], exactly 0 in every slot whose flag is False.
//
// Replaces no TPU kernel.  The JAX package's counterpart is plain XLA
// (mmwave_radar_processing_tpu/ops/mxu.py: rd_values_from_range_dft, one-hot
// matmuls, and aoa_peak_angles).  The port first carried it over as a
// torch.gather of every used channel's whole range row for every slot
// ([B, U, K, L]: 8.2 GB written and read again a call at 4096 frames, 7
// channels, 512 slots, 70 loops), a gather of the Doppler columns ([B, K, L]),
// a complex contraction, a [B, K, A] x [A, M] product and an argmax per
// subset, and the point, on every slot whether filled or not.
//
// The arithmetic, float32 throughout:
//   - the Doppler value: each lane sums its loops l = lane, lane + 32, ... in
//     ascending order (the same order whether the row is held or read again), each complex product as four fmaf (re += xr dr,
//     re -= xi di, im += xr di, im += xi dr); the 32 lanes' partial sums are
//     then added by a reduce-scatter: at offsets 16, 8, 4, 2, 1 in turn a lane
//     adds its partner's half of the values still held to the half it keeps
//     (the last levels, once a lane holds one value, add that value to its
//     partner's).  Only this order differs from the plain version's cuBLAS
//     contraction;
//   - the angle DFT: for each bin m, the subset's values in subset order with
//     the same four fmaf; the power re*re + im*im rounded product by product
//     and then summed (no contraction, as the plain version's three
//     elementwise passes); the argmax takes the first maximum, a NaN above
//     every number, as torch.argmax does;
//   - the point: r * range_res, then * cosf(el), then * cosf(az) (sinf(az));
//     r * range_res * sinf(el); v * vel_res + vel0: each product and sum
//     rounded as the plain version's elementwise passes round them.  cosf and
//     sinf are the accurate library functions (no --use_fast_math).
// A valid slot whose bins lie off R or dop gives NaN: the card cannot raise.
//
// What bounds it: the bytes of the filled slots' rows and the latency of
// each slot's short chain of steps.  A filled slot needs U rows of 8 L bytes
// (560 B at L = 70) and about 8 U L + 8 (A_az + A_el) M operations (~8 KFLOP
// at U = 7, L = 70, M = 64); an empty slot needs its flag read and 16 bytes
// of zeros written.  A frame's detections share rows (~5 slots a row in the
// velocity-analysis flight, ~2 in the point-cloud cells), so a row is read
// once for all its slots.  The design:
//   1. a block of 8 warps takes one frame and 256 of its slots, lane i of warp
//      w the slot 256 c + w + 8 i; each lane reads its flag, an empty slot's
//      lane writes its zeros (a block with no filled slot stops there), and
//      the block lists its filled slots in shared memory (a ballot a warp, a
//      prefix over the warps), whatever pattern the flags make, then orders
//      the list by range row (a count a row, a prefix sum, a place each) and
//      stages both angle DFT matrices in shared memory;
//   2. warp w takes the w-th eighth of that order: it reads a range row of
//      every channel once into registers (a lane the loops lane + 32 i,
//      i < kIt: coalesced reads; loops past 32 kIt are read again for each
//      slot) and keeps it while the next slot is on the same row; for each
//      slot the lanes multiply by the Doppler column (through L1) and the
//      reduce-scatter leaves each of the 2 U sums in one lane, which stores
//      it in shared memory;
//   3. four threads take each subset of a slot, each a quarter of the bins
//      (m = q, q + 4, ...), and combine their first largest powers by two
//      shuffles;
//   4. a thread a slot writes the point as one 16-byte store.
// Measured on the H100 (chip_smoke.py time_aoa_head): one launch of 0.54 ms
// at the velocity-analysis call's [4096, 7, 63, 70] with 512 slots, ~105
// filled a frame, where the gather it replaced took 20.8 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = kThreads;     // slots a block takes of one frame
constexpr int kMaxChannels = 16;     // distinct channels of R the angles read
constexpr int kMaxAntennas = 16;     // positions in one subset
// dynamic shared memory a block may take: the rows' counts and the angle DFTs
constexpr int kMaxDynamicBytes = 64 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// The channels read and each subset's entries in them, passed by value.
struct Layout {
  int n_ch, n_az, n_el;
  int ch[kMaxChannels];   // channels of R, on its channel axis
  int az[kMaxAntennas];   // the azimuth subset, as indices into ch
  int el[kMaxAntennas];   // the elevation subset, as indices into ch
};

__device__ __forceinline__ void cmac(float2& acc, float2 x, float2 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.x = fmaf(-x.y, w.y, acc.x);
  acc.y = fmaf(x.x, w.y, acc.y);
  acc.y = fmaf(x.y, w.x, acc.y);
}

// a beats b: larger, or NaN against a number (torch.argmax's order)
__device__ __forceinline__ bool beats(float a, float b) {
  return a > b || (isnan(a) && !isnan(b));
}

// One level of the reduce-scatter: a lane keeps the lower kHalf of its values
// or, if bit kOff of its lane is set, the upper, and adds its partner's.
template <int kHalf, int kOff, int kF>
__device__ __forceinline__ void scatter_level(float (&v)[kF], int lane, int& index) {
  if constexpr (kHalf >= 1 && kOff >= 1) {
    const bool upper = (lane & kOff) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[i + kHalf];
      const float keep = upper ? v[i + kHalf] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, kOff);
    }
    index += upper ? kHalf : 0;
    scatter_level<kHalf / 2, kOff / 2>(v, lane, index);
  }
}

// Sums each of the kF values over the warp's 32 lanes; returns the lane's
// share: the sum of value number `index`, which lanes 32 / kF apart share.
template <int kF>
__device__ __forceinline__ float reduce_scatter(float (&v)[kF], int lane, int& index) {
  static_assert(kF >= 2 && kF <= 32 && (kF & (kF - 1)) == 0, "a power of two up to 32");
  index = 0;
  scatter_level<kF / 2, 16>(v, lane, index);
#pragma unroll
  for (int off = 16 / kF; off >= 1; off /= 2) {
    v[0] += __shfl_xor_sync(kFull, v[0], off);
  }
  return v[0];
}

// kParts threads share a subset's bins, thread q taking m = q, q + kParts, ...
constexpr int kParts = 4;
// loops a lane keeps of a range row in registers: l = lane + 32 i, i < kMaxIters
constexpr int kMaxIters = 4;

// Thread q's part of one subset's peak: the first largest power of its
// zero-padded DFT (the n x bins matrix dft) over the thread's bins, and that
// bin (-1 for none).  x: the subset's values (the first n used).
template <int kA>
__device__ __forceinline__ void peak_part(const float2 (&x)[kA], int n, const float2* dft,
                                          int bins, int q, float& best, int& best_m) {
  best = 0.0f;
  best_m = -1;
  if (n == 0) return;
#pragma unroll 4
  for (int m = q; m < bins; m += kParts) {
    float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      if (a < n) cmac(s, x[a], dft[a * bins + m]);
    }
    const float p = __fadd_rn(__fmul_rn(s.x, s.x), __fmul_rn(s.y, s.y));
    if (best_m < 0 || beats(p, best)) {
      best = p;
      best_m = m;
    }
  }
}

// Dynamic shared memory of a block: a count, then a start, a row; the two
// angle DFT matrices.
__host__ __device__ __forceinline__ size_t dynamic_bytes(int rows, int n_az, int n_el, int bins) {
  const size_t counts = sizeof(int) * static_cast<size_t>(rows);
  return (counts + 7) / 8 * 8 + sizeof(float2) * static_cast<size_t>(n_az + n_el) * bins;
}

// kCh: the most channels or subset positions the instance holds in registers;
// kIt: the loops of a range row a lane keeps, l = lane + 32 i for i < kIt
// (the rest, past 32 kIt, is read again for each slot).
template <int kCh, int kIt>
__global__ void __launch_bounds__(kThreads)
aoa_head_kernel(const float2* __restrict__ R, long long batch_stride, int rows, int loops,
                const float2* __restrict__ dop, long long dop_l, long long dop_v, int dop_bins,
                const long long* __restrict__ r_idx, const long long* __restrict__ v_idx,
                const unsigned char* __restrict__ valid, int slots, int chunks,
                const __grid_constant__ Layout layout, const float2* __restrict__ az_dft,
                const float2* __restrict__ el_dft, const float* __restrict__ angle_bins,
                int bins, float range_res, float vel0, float vel_res, float4* __restrict__ out) {
  constexpr int kF = 2 * kCh;           // the floats of the kCh values
  __shared__ float s_vals[kChunk][kF];  // each listed slot's values, re and im
  __shared__ float s_ang[kChunk][2];    // each listed slot's azimuth and elevation
  __shared__ int s_slot[kChunk], s_r[kChunk], s_v[kChunk];
  __shared__ int s_order[kChunk];       // the listed slots on R's rows, by row
  __shared__ int s_count[kWarps];
  extern __shared__ float2 s_dyn[];
  int* s_row = reinterpret_cast<int*>(s_dyn);  // [rows]: a row's slots, then its start
  float2* s_dft = s_dyn + (static_cast<size_t>(rows) + 1) / 2;  // [n_az + n_el, bins]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.x / chunks;
  const int own = static_cast<int>(blockIdx.x % chunks) * kChunk + warp + kWarps * lane;
  const long long own_idx = b * slots + own;

  // 1. flags, zeros, the list of filled slots and its order by row
  const bool filled = own < slots && valid[own_idx] != 0;
  if (!filled && own < slots) out[own_idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const unsigned ballot = __ballot_sync(kFull, filled);
  if (lane == 0) s_count[warp] = __popc(ballot);
  for (int r = threadIdx.x; r < rows; r += kThreads) s_row[r] = 0;
  __syncthreads();
  int first = 0, listed = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first += w < warp ? s_count[w] : 0;
    listed += s_count[w];
  }
  if (listed == 0) return;  // the block's slots are all empty: their zeros are written
  const int j_own = first + __popc(ballot & ((1u << lane) - 1u));
  int r_own = -1;
  if (filled) {
    const long long r = __ldg(r_idx + own_idx), v = __ldg(v_idx + own_idx);
    const bool on = r >= 0 && r < rows && v >= 0 && v < dop_bins;
    r_own = on ? static_cast<int>(r) : -1;
    s_slot[j_own] = own;
    s_r[j_own] = r_own;
    s_v[j_own] = on ? static_cast<int>(v) : -1;
    if (on) atomicAdd(s_row + r_own, 1);
  }
  for (int k = threadIdx.x; k < (layout.n_az + layout.n_el) * bins; k += kThreads) {
    const int a = k / bins;
    s_dft[k] = a < layout.n_az ? __ldg(az_dft + k) : __ldg(el_dft + (k - layout.n_az * bins));
  }
  __syncthreads();
  if (warp == 0) {  // each row's start in the order: an exclusive prefix sum
    int carry = 0;
    for (int base = 0; base < rows; base += 32) {
      const int n = base + lane < rows ? s_row[base + lane] : 0;
      int sum = n;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFull, sum, off);
        sum += lane >= off ? up : 0;
      }
      if (base + lane < rows) s_row[base + lane] = carry + sum - n;
      carry += __shfl_sync(kFull, sum, 31);
    }
    if (lane == 0) s_count[0] = carry;  // the listed slots on R
  }
  __syncthreads();
  const int on_rows = s_count[0];
  if (r_own >= 0) s_order[atomicAdd(s_row + r_own, 1)] = j_own;
  __syncthreads();

  // 2. the values u[c] on every channel read: warp w takes the w-th eighth of
  // the order and keeps each range row it reads until the row changes
  if (layout.n_ch > 0) {
    const long long plane = static_cast<long long>(rows) * loops;
    const float2* frame = R + b * batch_stride;
    float2 x[kIt][kCh];
    int held = -1;
    const int p_end = (warp + 1) * on_rows / kWarps;
    for (int p = warp * on_rows / kWarps; p < p_end; ++p) {
      const int j = s_order[p], r = s_r[j];
      const float2* row = frame + static_cast<long long>(r) * loops;
      if (r != held) {
#pragma unroll
        for (int i = 0; i < kIt; ++i) {
          const int l = lane + 32 * i;
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            if (c < layout.n_ch && l < loops) x[i][c] = __ldg(row + layout.ch[c] * plane + l);
          }
        }
        held = r;
      }
      const float2* col = dop + s_v[j] * dop_v;
      float acc[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f) acc[f] = 0.0f;
#pragma unroll
      for (int i = 0; i < kIt; ++i) {
        const int l = lane + 32 * i;
        if (l < loops) {
          const float2 d = __ldg(col + l * dop_l);
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            if (c < layout.n_ch) {
              float2 s = make_float2(acc[2 * c], acc[2 * c + 1]);
              cmac(s, x[i][c], d);
              acc[2 * c] = s.x;
              acc[2 * c + 1] = s.y;
            }
          }
        }
      }
      for (int l = lane + 32 * kIt; l < loops; l += 32) {
        const float2 d = __ldg(col + l * dop_l);
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          if (c < layout.n_ch) {
            float2 s = make_float2(acc[2 * c], acc[2 * c + 1]);
            cmac(s, __ldg(row + layout.ch[c] * plane + l), d);
            acc[2 * c] = s.x;
            acc[2 * c + 1] = s.y;
          }
        }
      }
      int index;
      const float sum = reduce_scatter<kF>(acc, lane, index);
      if ((lane & (32 / kF - 1)) == 0) s_vals[j][index] = sum;
    }
  }
  __syncthreads();

  // 3. kParts threads a listed slot's subset: its bins, then the first peak
  // of the kParts parts (lanes 4k .. 4k + 3 share a subset)
  for (int t0 = 0; t0 < listed * 2 * kParts; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int j = t / (2 * kParts), subset = (t / kParts) & 1, q = t % kParts;
    const bool el = subset != 0;
    const int n = el ? layout.n_el : layout.n_az;
    float best = 0.0f;
    int best_m = -1;
    if (j < listed && s_r[j] >= 0) {
      const int* pos = el ? layout.el : layout.az;
      float2 xs[kCh];
#pragma unroll
      for (int a = 0; a < kCh; ++a) {
        const int c = a < n ? pos[a] : 0;
        xs[a] = make_float2(s_vals[j][2 * c], s_vals[j][2 * c + 1]);
      }
      peak_part<kCh>(xs, n, s_dft + (el ? layout.n_az * bins : 0), bins, q, best, best_m);
    }
#pragma unroll
    for (int off = 1; off < kParts; off <<= 1) {
      const float p = __shfl_xor_sync(kFull, best, off);
      const int m = __shfl_xor_sync(kFull, best_m, off);
      if (m >= 0 && (best_m < 0 || beats(p, best) || (!beats(best, p) && m < best_m))) {
        best = p;
        best_m = m;
      }
    }
    if (j < listed && q == 0) s_ang[j][subset] = best_m >= 0 ? __ldg(angle_bins + best_m) : 0.0f;
  }
  __syncthreads();

  // 4. a thread a listed slot: the point
  for (int j = threadIdx.x; j < listed; j += kThreads) {
    const int r = s_r[j], v = s_v[j];
    float4 pt;
    if (r < 0) {
      const float nan = __int_as_float(0x7fc00000);
      pt = make_float4(nan, nan, nan, nan);
    } else {
      const float az = s_ang[j][0], el = s_ang[j][1];
      const float rng = __fmul_rn(static_cast<float>(r), range_res);
      const float rc = __fmul_rn(rng, cosf(el));
      pt = make_float4(__fmul_rn(rc, cosf(az)), __fmul_rn(rc, sinf(az)),
                       __fmul_rn(rng, sinf(el)),
                       __fadd_rn(__fmul_rn(static_cast<float>(v), vel_res), vel0));
    }
    out[b * slots + s_slot[j]] = pt;
  }
}

// The instance for kCh channels held and kIt loops a lane keeps.
template <int kCh>
auto instance(int iters) {
  return iters <= 1 ? &aoa_head_kernel<kCh, 1>
         : iters == 2 ? &aoa_head_kernel<kCh, 2>
         : iters == 3 ? &aoa_head_kernel<kCh, 3> : &aoa_head_kernel<kCh, kMaxIters>;
}

constexpr int kMaxDevices = 64;
size_t granted[2][kMaxIters][kMaxDevices];  // per instance and device: dynamic shared memory

}  // namespace


// R [frames, channels, rows, loops] complex64 (float2) with its inner three
// dims contiguous and `batch_stride` complex values between frames; dop
// [loops, dop_bins] complex64 with strides dop_l, dop_v (in values); r_idx,
// v_idx [frames, slots] int64 and valid [frames, slots] bool, contiguous;
// az_dft [max(n_az, 1), bins] and el_dft [max(n_el, 1), bins] complex64 and
// angle_bins [bins] float32, contiguous; out [frames, slots, 4] float32,
// contiguous and 16-byte aligned.  ch (n_ch entries), az (n_az), el (n_el) are
// host arrays: the channels of R read, and each subset's indices into ch.
// frames, slots, bins >= 1, n_ch, n_az, n_el within their maxima, each ch in
// [0, channels), each az and el in [0, n_ch), at most 2^31 - 1 blocks, else
// cudaErrorInvalidValue and nothing launched.  Returns a cudaError_t as int.
extern "C" int aoa_head(const void* R, long long batch_stride, int channels, int rows, int loops,
                        const void* dop, long long dop_l, long long dop_v, int dop_bins,
                        const long long* r_idx, const long long* v_idx,
                        const unsigned char* valid, long long frames, int slots,
                        const int* ch, int n_ch, const int* az, int n_az, const int* el,
                        int n_el, const void* az_dft, const void* el_dft,
                        const float* angle_bins, int bins, float range_res, float vel0,
                        float vel_res, float* out, cudaStream_t stream) {
  if (frames < 1 || slots < 1 || bins < 1 || rows < 1 || loops < 1 || dop_bins < 1
      || n_ch < 0 || n_ch > kMaxChannels || n_ch > channels || n_az < 0
      || n_az > kMaxAntennas || n_el < 0 || n_el > kMaxAntennas
      || (n_ch == 0 && (n_az > 0 || n_el > 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layout layout = {};
  layout.n_ch = n_ch;
  layout.n_az = n_az;
  layout.n_el = n_el;
  for (int c = 0; c < n_ch; ++c) {
    if (ch[c] < 0 || ch[c] >= channels) return static_cast<int>(cudaErrorInvalidValue);
    layout.ch[c] = ch[c];
  }
  for (int a = 0; a < n_az; ++a) {
    if (az[a] < 0 || az[a] >= n_ch) return static_cast<int>(cudaErrorInvalidValue);
    layout.az[a] = az[a];
  }
  for (int a = 0; a < n_el; ++a) {
    if (el[a] < 0 || el[a] >= n_ch) return static_cast<int>(cudaErrorInvalidValue);
    layout.el[a] = el[a];
  }
  const long long chunks = (slots + kChunk - 1) / kChunk;
  if (frames > 0x7fffffffLL / chunks) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(frames * chunks);
  // the values a lane keeps: up to 8 channels and subset positions, or up to 16
  const int widest = n_ch > n_az ? (n_ch > n_el ? n_ch : n_el) : (n_az > n_el ? n_az : n_el);
  const int iters = loops <= 32 * kMaxIters ? (loops + 31) / 32 : kMaxIters;
  auto kernel = widest <= 8 ? instance<8>(iters) : instance<kMaxChannels>(iters);
  const size_t smem = dynamic_bytes(rows, n_az, n_el, bins);
  if (smem > static_cast<size_t>(kMaxDynamicBytes)) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t* grant = device >= 0 && device < kMaxDevices
                      ? &granted[widest <= 8 ? 0 : 1][iters - 1][device] : nullptr;
  if (grant == nullptr || smem > *grant) {  // once a device and size, not every launch
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (grant != nullptr) *grant = smem;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float2*>(R), batch_stride, rows, loops, static_cast<const float2*>(dop),
      dop_l, dop_v, dop_bins, r_idx, v_idx, valid, slots, static_cast<int>(chunks), layout,
      static_cast<const float2*>(az_dft), static_cast<const float2*>(el_dft), angle_bins, bins,
      range_res, vel0, vel_res, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
