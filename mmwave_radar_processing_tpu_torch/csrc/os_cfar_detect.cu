// Counting OS-CFAR 2D detection for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   mmwave_radar_processing_tpu/ops/pallas/os_cfar.py :: os_cfar_2d_detect_fused
// (body _detect_kernel).  Same arithmetic as the XLA form in
// mmwave_radar_processing_tpu/ops/cfar.py :: os_2d_detect: an interior cell
// (r, c) is detected iff
//     #{training offsets (i, j) : alpha * x[r-er+i][c-ed+j] < x[r][c]} >= k
// with the float32 product rounded once (no contraction into an FMA: there
// is nothing to contract with, and __fmul_rn makes it explicit).  Cells within
// er = tr+gr rows or ed = td+gd columns of an edge are 0, as are all cells of
// a map smaller than one window.
//
// Design: one thread block per frame.  The block copies its R x D map into
// shared memory once (63 x 70 floats = 17.6 KB on the flagship config), then
// its threads stride over the cells; each interior cell walks its
// (2er+1) x (2ed+1) window in shared memory and skips the guard box.  One
// byte per cell is written, edges included.
//
// Bound: per flagship frame the kernel reads 17.6 KB and writes 4.4 KB of
// device memory, but does 47*56 interior cells x 255 window reads
// (~0.67 M shared-memory reads, ~0.58 M of them counted compare-adds), so it
// is bound by shared-memory bandwidth and the ALU, not by HBM.  Neighbouring
// threads take neighbouring columns, so a warp's shared-memory reads hit 32
// consecutive words (no bank conflicts).  The TPU layout (batch on the
// 128-lane axis, transposes on the way in and out, edge padding built by
// concatenation) is deliberately not carried over.
//
// Built by nvcc into a shared library with a plain C entry point, loaded with
// ctypes (mmwave_radar_processing_tpu_torch/ops/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
os_cfar_2d_detect_kernel(const float* __restrict__ x, uint8_t* __restrict__ out,
                         int rows, int cols, int tr, int td, int gr, int gd,
                         int k, float alpha) {
  extern __shared__ float tile[];
  const int n = rows * cols;
  const float* xb = x + static_cast<size_t>(blockIdx.x) * n;
  uint8_t* ob = out + static_cast<size_t>(blockIdx.x) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = xb[i];
  __syncthreads();

  const int er = tr + gr, ed = td + gd;
  const int win_r = 2 * er + 1, win_d = 2 * ed + 1;
  const int gr1 = tr + 2 * gr, gd1 = td + 2 * gd;  // guard box: [tr, gr1] x [td, gd1]

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int r = idx / cols;
    const int c = idx - r * cols;
    uint8_t det = 0;
    if (r >= er && r < rows - er && c >= ed && c < cols - ed) {
      const float cut = tile[idx];
      int count = 0;
      for (int i = 0; i < win_r; ++i) {
        const float* row = tile + (r - er + i) * cols + (c - ed);
        const bool guard_row = i >= tr && i <= gr1;
        for (int j = 0; j < win_d; ++j) {
          const bool guard = guard_row && j >= td && j <= gd1;
          count += (!guard && __fmul_rn(alpha, row[j]) < cut) ? 1 : 0;
        }
      }
      det = count >= k ? 1 : 0;
    }
    ob[idx] = det;
  }
}

}  // namespace

// x: float32 [batch, rows, cols] contiguous; out: uint8/bool, same shape.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int os_cfar_2d_detect(const void* x, void* out, int batch, int rows,
                                 int cols, int tr, int td, int gr, int gd,
                                 int k, float alpha, void* stream) {
  const size_t smem = static_cast<size_t>(rows) * cols * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        os_cfar_2d_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  os_cfar_2d_detect_kernel<<<batch, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(out), rows, cols, tr,
      td, gr, gd, k, alpha);
  return static_cast<int>(cudaGetLastError());
}
