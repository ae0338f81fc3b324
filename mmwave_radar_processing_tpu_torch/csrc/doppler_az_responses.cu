// Doppler-azimuth responses of antenna sub-arrays, for Hopper (sm_90a).
//
// Replaces three TPU kernels of mmwave_radar_processing_tpu/ops/pallas/doppler_az.py,
// which compute one function in three layouts:
//   set_responses_pallas_batch    (frames blocked per grid step),
//   set_responses_pallas          (one frame; the zoom pass),
//   group_responses_pallas_batch  (two sets side by side on the lanes).
// For each frame b, set s, angle bin a and velocity bin v:
//
//   out[b,s,a,v] = sum_w wgt[b,w] * | sum_r F[a, s*n_rx+r] * u[b, set_idx[s][r], w*nv+v] |
//
// in the JAX sign convention re' = fc*re + fs*im, im' = fc*im - fs*re, with
// F = fct - j*fst.  The order of operations is that of the Pallas kernel
// body (_kernel_batch): over r the products and sums accumulate one at a
// time, then sqrt(re*re + im*im), then the weighted sum over w in order.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: no FMA contraction) and sqrtf is IEEE (no -use_fast_math), so
// the result equals the plain PyTorch version (ops/doppler_az.py
// set_responses_reference, run on the card) bit for bit.
//
// What bounds it on this card: per flagship frame (12 channels, W = 19 rows,
// nv = 70, 4 sets, Av = 60) the kernel reads 128 KB of spectrum and writes
// 67 KB, but forms 4*60*19*70 = 319k spectrum points of 4 complex products
// each: instruction throughput, not device memory.  With every product and sum
// rounded on its own a point costs 30 multiplies and adds, an IEEE square root
// of about ten instructions, a weight and a sum: about 45 instructions where
// the bound that counts an FMA as two operations at the float32 peak counts
// 18 instruction slots.  The kernel cannot go under about twice that bound.
//
// Design: a thread owns one (b, s, v) and kAngles = 4 neighbouring angle bins.
// It loads their kAngles x n_rx factor pairs once, before the loop over range
// rows, and keeps them and kAngles running sums in registers (n_rx = 4 is a
// template parameter; another n_rx reads the factors through the read-only
// path inside a run-time loop).  Per range row it loads the 2*n_rx spectrum
// values and the weight once and does the kAngles bins' arithmetic from
// registers: 9 loads for kAngles outputs where one thread an output made 17
// for one, and every spectrum element is fetched by Av / kAngles threads of
// its set instead of Av.  Offsets inside a frame are 32-bit, so a load's
// address is one multiply-add on the frame's base.  Neighbouring threads sit on
// neighbouring v, so the loads along v are coalesced and each bin's store is
// one contiguous run.  A ragged last block of angle bins is masked.  The
// channel table set_idx is a kernel argument (constant bank), so one kernel
// serves the three layouts.  The TPU layout is not carried over: no frames
// blocked per grid step, no channels on sublanes, no weights in SMEM.
//
// Times (NVIDIA H100 80GB HBM3, 700.00 W; batch 1024, in turns with the
// earlier kernel in one job): one thread an output 2.69 ms at [12, 19*70] and
// 5.36 ms at the zoom width [12, 19*140]; angle bins in registers 0.94 / 1.87
// (4 and 6 bins a thread alike, 5 at 1.05 / 2.07 and 10 at 1.25 / 2.54
// slower); 32-bit offsets 0.77 / 1.52 at 4 bins a thread (80 registers, 3
// blocks an SM), 0.86 / 1.67 at 6 (128 registers): 4 it is, for every angle
// count.  The main loop then runs 59 instructions a point and row (236 a row,
// from 296), of which 34 are the arithmetic and 10 the square root.
//
// Built by nvcc into a shared library with a plain C entry point, loaded
// with ctypes (mmwave_radar_processing_tpu_torch/ops/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAngles = 4;     // angle bins a thread
constexpr int kMaxTable = 64;  // n_sets * n_rx entries of set_idx

struct SetTable {
  int ch[kMaxTable];
};

// kRx > 0: n_rx == kRx, factors in registers.  kRx == 0: any n_rx, factors
// read inside the loop.
template <int kRx>
__global__ void __launch_bounds__(kThreads)
doppler_az_responses_kernel(const float* __restrict__ u_re,
                            const float* __restrict__ u_im,
                            const float* __restrict__ wgt,
                            const float* __restrict__ fct,
                            const float* __restrict__ fst,
                            float* __restrict__ out, const SetTable table,
                            long long total, int n_ch, int win_rows, int nv,
                            int n_sets, int n_rx, int n_angles, int angle_blocks) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int v = static_cast<int>(idx % nv);
  long long rest = idx / nv;
  const int a0 = static_cast<int>(rest % angle_blocks) * kAngles;
  rest /= angle_blocks;
  const int s = static_cast<int>(rest % n_sets);
  const long long b = rest / n_sets;

  // offsets inside a frame are 32-bit (the entry point checks that they fit):
  // a load's address is then one multiply-add on the frame's base
  const int m = win_rows * nv;
  const float* ure = u_re + b * n_ch * m + v;
  const float* uim = u_im + b * n_ch * m + v;
  const float* wb = wgt + b * win_rows;
  const int n_cols = n_sets * n_rx;
  const float* fc_row = fct + static_cast<long long>(a0) * n_cols + s * n_rx;
  const float* fs_row = fst + static_cast<long long>(a0) * n_cols + s * n_rx;

  constexpr int kKept = kRx > 0 ? kRx : 1;
  float fc[kAngles][kKept], fs[kAngles][kKept];
  int ch_off[kKept];
  if constexpr (kRx > 0) {
#pragma unroll
    for (int i = 0; i < kAngles; ++i) {
      const bool live = a0 + i < n_angles;
#pragma unroll
      for (int r = 0; r < kRx; ++r) {
        fc[i][r] = live ? __ldg(fc_row + i * n_cols + r) : 0.0f;
        fs[i][r] = live ? __ldg(fs_row + i * n_cols + r) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRx; ++r) ch_off[r] = table.ch[s * kRx + r] * m;
  }

  float acc[kAngles];
#pragma unroll
  for (int i = 0; i < kAngles; ++i) acc[i] = 0.0f;

  for (int w = 0, row = 0; w < win_rows; ++w, row += nv) {
    const float weight = __ldg(wb + w);
    float sp_re[kAngles], sp_im[kAngles];
    if constexpr (kRx > 0) {
      float ur[kRx], ui[kRx];
#pragma unroll
      for (int r = 0; r < kRx; ++r) {
        ur[r] = ure[ch_off[r] + row];
        ui[r] = uim[ch_off[r] + row];
      }
#pragma unroll
      for (int i = 0; i < kAngles; ++i) {
#pragma unroll
        for (int r = 0; r < kRx; ++r) {
          const float t_re = __fadd_rn(__fmul_rn(fc[i][r], ur[r]), __fmul_rn(fs[i][r], ui[r]));
          const float t_im = __fsub_rn(__fmul_rn(fc[i][r], ui[r]), __fmul_rn(fs[i][r], ur[r]));
          sp_re[i] = r == 0 ? t_re : __fadd_rn(sp_re[i], t_re);
          sp_im[i] = r == 0 ? t_im : __fadd_rn(sp_im[i], t_im);
        }
      }
    } else {
      for (int r = 0; r < n_rx; ++r) {
        const int off = table.ch[s * n_rx + r] * m + row;
        const float ur = ure[off];
        const float ui = uim[off];
#pragma unroll
        for (int i = 0; i < kAngles; ++i) {
          const bool live = a0 + i < n_angles;
          const float c = live ? __ldg(fc_row + i * n_cols + r) : 0.0f;
          const float d = live ? __ldg(fs_row + i * n_cols + r) : 0.0f;
          const float t_re = __fadd_rn(__fmul_rn(c, ur), __fmul_rn(d, ui));
          const float t_im = __fsub_rn(__fmul_rn(c, ui), __fmul_rn(d, ur));
          sp_re[i] = r == 0 ? t_re : __fadd_rn(sp_re[i], t_re);
          sp_im[i] = r == 0 ? t_im : __fadd_rn(sp_im[i], t_im);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kAngles; ++i) {
      const float mag = sqrtf(__fadd_rn(__fmul_rn(sp_re[i], sp_re[i]),
                                        __fmul_rn(sp_im[i], sp_im[i])));
      const float term = __fmul_rn(weight, mag);
      acc[i] = (w == 0) ? term : __fadd_rn(acc[i], term);
    }
  }

  // out[b, s, a0 + i, v]
  float* o = out + ((b * n_sets + s) * n_angles + a0) * nv + v;
#pragma unroll
  for (int i = 0; i < kAngles; ++i) {
    if (a0 + i < n_angles) o[static_cast<long long>(i) * nv] = acc[i];
  }
}

}  // namespace

// u_re, u_im: float32 [batch, n_ch, win_rows*nv]; wgt: float32 [batch, win_rows];
// fct, fst: float32 [n_angles, n_sets*n_rx]; set_idx: host int32 [n_sets*n_rx];
// out: float32 [batch, n_sets, n_angles, nv].  All device arrays contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a table longer than kMaxTable or a frame of 2^31
// or more spectrum values.
extern "C" int doppler_az_responses(const void* u_re, const void* u_im,
                                    const void* wgt, const void* fct,
                                    const void* fst, const int* set_idx,
                                    void* out, int batch, int n_ch,
                                    int win_rows, int nv, int n_sets, int n_rx,
                                    int n_angles, void* stream) {
  if (n_sets * n_rx > kMaxTable) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(n_ch) * win_rows * nv > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  SetTable table = {};
  for (int i = 0; i < n_sets * n_rx; ++i) table.ch[i] = set_idx[i];
  const float* ure = static_cast<const float*>(u_re);
  const float* uim = static_cast<const float*>(u_im);
  const float* wp = static_cast<const float*>(wgt);
  const float* fc = static_cast<const float*>(fct);
  const float* fs = static_cast<const float*>(fst);
  float* op = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int angle_blocks = (n_angles + kAngles - 1) / kAngles;
  const long long total = static_cast<long long>(batch) * n_sets * angle_blocks * nv;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (n_rx == 4) {
    doppler_az_responses_kernel<4><<<blocks, kThreads, 0, st>>>(
        ure, uim, wp, fc, fs, op, table, total, n_ch, win_rows, nv, n_sets, n_rx, n_angles,
        angle_blocks);
  } else {
    doppler_az_responses_kernel<0><<<blocks, kThreads, 0, st>>>(
        ure, uim, wp, fc, fs, op, table, total, n_ch, win_rows, nv, n_sets, n_rx, n_angles,
        angle_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
