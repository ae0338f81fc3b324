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
// Design: one thread per output (b, s, a, v), neighbouring threads on
// neighbouring v, so the loads of u along v are coalesced and the store is
// one contiguous run.  The TPU layout is not carried over: no frames
// blocked per grid step, no channels on sublanes, no weights in SMEM.  The
// channel table set_idx is a kernel argument (constant bank); fct, fst and
// wgt are read through the read-only path (a warp shares at most two angle
// bins and one frame, so those loads are broadcasts).
//
// Bound: per flagship frame (12 channels, W = 19 rows, nv = 70, 4 sets,
// Av = 60) the kernel reads 128 KB of spectrum and writes 67 KB, but forms
// 4*60*19*70 = 319k spectrum points of 4 complex products each, ~22 flops a
// point: it is bound by the ALU and its L1/L2 loads (each u element is read
// by the Av threads of its set), not by HBM bandwidth.
//
// Built by nvcc into a shared library with a plain C entry point, loaded
// with ctypes (mmwave_radar_processing_tpu_torch/ops/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTable = 64;  // n_sets * n_rx entries of set_idx

struct SetTable {
  int ch[kMaxTable];
};

__global__ void __launch_bounds__(kThreads)
doppler_az_responses_kernel(const float* __restrict__ u_re,
                            const float* __restrict__ u_im,
                            const float* __restrict__ wgt,
                            const float* __restrict__ fct,
                            const float* __restrict__ fst,
                            float* __restrict__ out, const SetTable table,
                            long long total, int n_ch, int win_rows, int nv,
                            int n_sets, int n_rx, int n_angles) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int v = static_cast<int>(idx % nv);
  long long rest = idx / nv;
  const int a = static_cast<int>(rest % n_angles);
  rest /= n_angles;
  const int s = static_cast<int>(rest % n_sets);
  const long long b = rest / n_sets;

  const long long m = static_cast<long long>(win_rows) * nv;
  const float* ure = u_re + b * n_ch * m + v;
  const float* uim = u_im + b * n_ch * m + v;
  const float* wb = wgt + b * win_rows;
  const int n_cols = n_sets * n_rx;
  const float* fc_row = fct + static_cast<long long>(a) * n_cols + s * n_rx;
  const float* fs_row = fst + static_cast<long long>(a) * n_cols + s * n_rx;

  float acc = 0.0f;
  for (int w = 0; w < win_rows; ++w) {
    float sp_re = 0.0f, sp_im = 0.0f;
    for (int r = 0; r < n_rx; ++r) {
      const long long off = table.ch[s * n_rx + r] * m + static_cast<long long>(w) * nv;
      const float ur = ure[off];
      const float ui = uim[off];
      const float fc = __ldg(fc_row + r);
      const float fs = __ldg(fs_row + r);
      const float t_re = __fadd_rn(__fmul_rn(fc, ur), __fmul_rn(fs, ui));
      const float t_im = __fsub_rn(__fmul_rn(fc, ui), __fmul_rn(fs, ur));
      if (r == 0) {
        sp_re = t_re;
        sp_im = t_im;
      } else {
        sp_re = __fadd_rn(sp_re, t_re);
        sp_im = __fadd_rn(sp_im, t_im);
      }
    }
    const float mag = sqrtf(__fadd_rn(__fmul_rn(sp_re, sp_re), __fmul_rn(sp_im, sp_im)));
    const float term = __fmul_rn(__ldg(wb + w), mag);
    acc = (w == 0) ? term : __fadd_rn(acc, term);
  }
  out[idx] = acc;
}

}  // namespace

// u_re, u_im: float32 [batch, n_ch, win_rows*nv]; wgt: float32 [batch, win_rows];
// fct, fst: float32 [n_angles, n_sets*n_rx]; set_idx: host int32 [n_sets*n_rx];
// out: float32 [batch, n_sets, n_angles, nv].  All device arrays contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a table longer than kMaxTable.
extern "C" int doppler_az_responses(const void* u_re, const void* u_im,
                                    const void* wgt, const void* fct,
                                    const void* fst, const int* set_idx,
                                    void* out, int batch, int n_ch,
                                    int win_rows, int nv, int n_sets, int n_rx,
                                    int n_angles, void* stream) {
  if (n_sets * n_rx > kMaxTable) return static_cast<int>(cudaErrorInvalidValue);
  SetTable table = {};
  for (int i = 0; i < n_sets * n_rx; ++i) table.ch[i] = set_idx[i];
  const long long total = static_cast<long long>(batch) * n_sets * n_angles * nv;
  const long long blocks = (total + kThreads - 1) / kThreads;
  doppler_az_responses_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u_re), static_cast<const float*>(u_im),
      static_cast<const float*>(wgt), static_cast<const float*>(fct),
      static_cast<const float*>(fst), static_cast<float*>(out), table, total,
      n_ch, win_rows, nv, n_sets, n_rx, n_angles);
  return static_cast<int>(cudaGetLastError());
}
