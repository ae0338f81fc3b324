// Helpers shared by the OS-CFAR sources (os_rank_select.cu, os_cfar_detect.cu) and
// dbs_pick.cu:
// a run length handed to a loop body as a compile-time constant, and the grant
// of more than 48 KB of dynamic shared memory to a kernel.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

template <int kValue>
struct Constant {
  __device__ constexpr operator int() const { return kValue; }
};

// Calls f(c) with c a compile-time constant equal to `len` (a Constant, which
// converts to int), kLo <= len <= kHi, found by bisection: the body that f
// inlines then has its run length as a constant, and its loops unroll into
// straight-line code.
template <int kLo, int kHi, class F>
__device__ __forceinline__ void with_constant_length(int len, F&& f) {
  if constexpr (kLo == kHi) {
    f(Constant<kLo>{});
  } else {
    constexpr int kMid = (kLo + kHi) / 2;
    if (len <= kMid) {
      with_constant_length<kLo, kMid>(len, f);
    } else {
      with_constant_length<kMid + 1, kHi>(len, f);
    }
  }
}

// Runs of up to kMaxConstantRun columns get their length as a constant; a
// wider window's runs are loops (f is then called with the int itself).
constexpr int kMaxConstantRun = 31;

template <class F>
__device__ __forceinline__ void with_run_length(int len, F&& f) {
  if (len > kMaxConstantRun) {
    f(len);
  } else {
    with_constant_length<0, kMaxConstantRun>(len, f);
  }
}

constexpr int kMaxSharedBytes = 227 * 1024;  // a block's dynamic shared memory on Hopper

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a kernel must be granted it first: once
// a device and size, not every launch (a per-frame path launches once a frame
// and is host-bound).  `granted` is the caller's static table for this kernel,
// kMaxDevices entries, zero-initialised.  Returns a cudaError_t as int.
template <class Kernel>
int grant_dynamic_shared(Kernel kernel, size_t smem, size_t* granted) {
  if (smem <= 48 * 1024) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool known = device >= 0 && device < kMaxDevices;
  if (!known || smem > granted[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (known) granted[device] = smem;
  }
  return 0;
}

constexpr bool is_power_of_two(int v) { return v > 0 && (v & (v - 1)) == 0; }
