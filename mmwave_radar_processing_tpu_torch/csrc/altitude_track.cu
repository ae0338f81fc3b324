// The altimeter recursion of the ground scan on Hopper (sm_90a): one block, one
// thread walks the frames.
//
// Replaces the lax.scan of
//   mmwave_radar_processing_tpu/parallel/ground_pipeline.py :: pipeline (alt_step)
// which is no Pallas kernel: the JAX package leaves the recursion to XLA's
// scan.  Everything of the scan that does not depend on the tracked altitude
// runs batched before this kernel (the coarse candidates and, for every
// candidate, its zoom refinements); the kernel keeps only what does.  Per
// frame t, with `cur` the tracked altitude (ops/altitude.py has the plain
// version and the rule in full):
//   gp      = the lowest candidate c[t, j] with valid[t, j], c >= min_alt and
//             |c - cur| <= limit, else -1;
//   precise:  when gp >= 0, `refined` = the same rule over the refinements
//             z[t, j*, k] of the first such candidate j* equal to gp, and
//             new = refined > 0 ? refined : cur; else new = cur;
//   else:     new = gp >= 0 ? gp : cur;
//   alts[t] = new + bias, and new is carried.
// Compares, selects and one float add, so the result equals the plain
// version's bit for bit.
//
// What bounds it: the chain of dependent operations from one frame's altitude
// to the next, some 10 to 20 instructions on one thread: tens of cycles a
// frame, tens of microseconds at T = 1024, where its bytes (49 a frame) and
// its operations would take nanoseconds on the whole card.  The design keeps
// everything else off that chain:
//   1. the gate's parts that do not depend on `cur` (valid, c >= min_alt) are
//      applied by the other threads while the inputs are staged: a candidate
//      that fails them is stored as +inf, which fails |c - cur| <= limit too;
//   2. the inputs are staged in shared memory in chunks of kChunk frames, two
//      buffers: while thread 0 walks one chunk, warps 1-7 load and gate the
//      next, so the walker never waits on device memory after the first chunk;
//   3. the walker reads shared memory only, and stores each frame's output
//      straight to device memory (stores do not stall it).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;  // frames a buffer
constexpr int kCand = 3;     // coarse candidates a frame
constexpr int kZoom = 2;     // refinements a candidate

struct Stage {
  float cand[kChunk * kCand];           // +inf where the static gate fails
  float zbins[kChunk * kCand * kZoom];  // the same for the refinements
};  // 18 KB; two of them fit a block's static shared memory

__device__ __forceinline__ float gated(float r, uint8_t v, float min_alt) {
  return (v != 0 && r >= min_alt) ? r : INFINITY;
}

// Stage frames [first, first + n) into s: thread `lane` of `lanes` threads.
__device__ void load_chunk(Stage& s, const float* __restrict__ cand,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ zbins,
                           const uint8_t* __restrict__ zvalid, long long first,
                           int n, bool precise, float min_alt, int lane, int lanes) {
  const long long c0 = first * kCand;
  for (int i = lane; i < n * kCand; i += lanes) {
    s.cand[i] = gated(cand[c0 + i], valid[c0 + i], min_alt);
  }
  if (precise) {
    const long long z0 = first * kCand * kZoom;
    for (int i = lane; i < n * kCand * kZoom; i += lanes) {
      s.zbins[i] = gated(zbins[z0 + i], zvalid[z0 + i], min_alt);
    }
  }
}

// The walk over one staged chunk; `cur` is the carry.
__device__ float walk_chunk(const Stage& s, int n, float cur, float limit, float bias,
                            bool precise, float* __restrict__ alts) {
  for (int f = 0; f < n; ++f) {
    float gp = INFINITY;
    int jb = 0;
#pragma unroll
    for (int j = 0; j < kCand; ++j) {
      const float r = s.cand[f * kCand + j];
      if (fabsf(r - cur) <= limit && r < gp) {
        gp = r;
        jb = j;
      }
    }
    const float gpv = gp < INFINITY ? gp : -1.0f;
    float next = cur;
    if (gpv >= 0.0f) {
      if (precise) {
        float rf = INFINITY;
#pragma unroll
        for (int k = 0; k < kZoom; ++k) {
          const float z = s.zbins[(f * kCand + jb) * kZoom + k];
          if (fabsf(z - cur) <= limit && z < rf) rf = z;
        }
        const float refined = rf < INFINITY ? rf : -1.0f;
        next = refined > 0.0f ? refined : cur;
      } else {
        next = gpv;
      }
    }
    alts[f] = __fadd_rn(next, bias);
    cur = next;
  }
  return cur;
}

__global__ void __launch_bounds__(kThreads)
altitude_track_kernel(const float* __restrict__ cand, const uint8_t* __restrict__ valid,
                      const float* __restrict__ zbins, const uint8_t* __restrict__ zvalid,
                      const float* __restrict__ init, float* __restrict__ alts,
                      float* __restrict__ final_alt, long long frames, float min_alt,
                      float limit, float bias, int precise_flag) {
  __shared__ Stage stage[2];
  const bool precise = precise_flag != 0;
  const int tid = threadIdx.x;
  const long long chunks = (frames + kChunk - 1) / kChunk;
  auto chunk_len = [&](long long c) {
    const long long left = frames - c * kChunk;
    return static_cast<int>(left < kChunk ? left : kChunk);
  };
  load_chunk(stage[0], cand, valid, zbins, zvalid, 0, chunk_len(0), precise, min_alt,
             tid, kThreads);
  __syncthreads();
  float cur = 0.0f;
  if (tid == 0) cur = *init;
  for (long long c = 0; c < chunks; ++c) {
    if (tid == 0) {
      cur = walk_chunk(stage[c & 1], chunk_len(c), cur, limit, bias, precise,
                       alts + c * kChunk);
    } else if (tid >= 32 && c + 1 < chunks) {
      load_chunk(stage[(c + 1) & 1], cand, valid, zbins, zvalid, (c + 1) * kChunk,
                 chunk_len(c + 1), precise, min_alt, tid - 32, kThreads - 32);
    }
    __syncthreads();
  }
  if (tid == 0) *final_alt = cur;
}

}  // namespace

// cand, valid [frames, 3]; zbins, zvalid [frames, 3, 2] (not read unless
// precise); init, final_alt one float each; alts [frames].  frames >= 1.
// Returns a cudaError_t as int.
extern "C" int altitude_track(const float* cand, const uint8_t* valid, const float* zbins,
                              const uint8_t* zvalid, const float* init, float* alts,
                              float* final_alt, long long frames, float min_alt,
                              float limit, float bias, int precise, cudaStream_t stream) {
  altitude_track_kernel<<<1, kThreads, 0, stream>>>(cand, valid, zbins, zvalid, init, alts,
                                                    final_alt, frames, min_alt, limit, bias,
                                                    precise);
  return static_cast<int>(cudaGetLastError());
}
