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
// Output: float32 [B, W, M].  For each frame b and range bin w (a "row"):
//
//   R      = X X^H / K                       X = x[b, :, w, :]  (A x K)
//   Capon:    R' = R + (loading * tr(R) / A + 1e-12) I = L L^H (complex Cholesky)
//             P_m = 1 / max(||L^-1 a_m||^2, tiny)
//   Bartlett: P_m = sum_i |a_im|^2 r_ii + 2 sum_{i>j} Re(r_ij conj(a_im) a_jm)
//
// The Cholesky diagonal is sqrt(max(s, tiny)) as in the JAX package.  The plain
// PyTorch versions are ops/beamform.py capon_power_reference and
// bartlett_power_reference; the sums run in another order here (eight threads
// over the chirps, then a shuffle tree), so results agree to float32 rounding,
// not bit for bit.
//
// Bound: at the flagship shape (B = 1024, A = 4, W = 63, K = 70, M = 64) the
// kernel reads 144 MB and writes 16.5 MB, 48 us at the card's 3.35 TB/s; its
// arithmetic (~1e9 flops) needs ~15 us.  It is bound by bytes, so the design
// keeps enough of them in flight to stream at the card's rate:
//
//  1. Tiles.  A block owns tiles of up to 16 consecutive rows in (b, w) order.
//     Within a frame antenna i's part of a tile is one contiguous run; whole
//     frames of a tile are one run together (at W = 1 the whole tile); a tile
//     that straddles frames is split into runs at the frame edges.  A row
//     larger than a stage is split into chunks of K, one row a tile.  The
//     geometry is a function of the shape (make_geometry, tile_run), mirrored
//     in ops/kernels/beamform.py and exported for the comparison of the two.
//  2. A ring of kStages shared-memory stages per block, persistent blocks
//     walking their tiles: a stage is refilled as soon as the tile in it has
//     been read, so the next tile is in flight while this one is computed.
//     The runs are TMA bulk copies (cp.async.bulk, completing on an mbarrier)
//     when every run is 16-byte aligned (K even and x 16-byte aligned);
//     otherwise every thread copies 8-byte elements with cp.async, which
//     arrive on the same mbarrier.  Up to 48 KB a stage (35.8 KB at the
//     flagship shape: 76 KB a block, three blocks an SM).
//  3. Covariance from shared memory: a group of 8 threads takes a row, splits
//     its chirps, loads each antenna's sample once a chirp and accumulates the
//     A(A+1)/2 entries in registers (at most 36 at a time: A > 8 takes several
//     passes); a shuffle tree over the group reduces them.
//  4. Factorisation, one thread a row: loading, Cholesky and L^-1 in place on
//     the packed lower triangle, in that thread's registers for A <= 8 and in
//     the tile's shared memory above; no barrier per column.
//  5. Angles: the block's threads run over the tile's (row, m) pairs, whose
//     outputs are one contiguous run of the tile's rows: coalesced stores.  The
//     steering stays in registers while a thread's m does not change, and is
//     staged in shared memory when it takes at most 32 KB.
// The TPU layout (frames blocked per grid step, range bins on sublanes,
// precomputed angle-pair constants) is not carried over.
//
// Built by nvcc into a shared library with a plain C entry point, loaded with
// ctypes (mmwave_radar_processing_tpu_torch/ops/kernels/_build.py).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 8;                        // threads that share a row's chirps
constexpr int kMaxTileRows = kThreads / kGroup;  // 16
constexpr int kStages = 2;
constexpr int kStageCap = 48 * 1024;  // bytes of x a stage holds at most
constexpr int kSteerCap = 32 * 1024;  // steering staged in shared memory up to this
constexpr int kMinTiles = 264;        // two per SM of the H100, where the rows allow
constexpr int kBarBytes = 128;        // the stages' mbarriers, ahead of the stages
constexpr int kSmemMax = 232448;      // 227 KB: what one block may use
constexpr int kMaxAntennas = 16;
constexpr int kEntryPass = 36;  // covariance entries a thread accumulates at once
constexpr float kTiny = FLT_MIN;  // jnp.finfo(float32).tiny
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
__host__ __device__ inline long long lmin(long long a, long long b) { return a < b ? a : b; }
__host__ __device__ inline long long lmax(long long a, long long b) { return a > b ? a : b; }

struct Geometry {
  int tile_rows;    // rows a tile
  int chunk;        // chirps of a row a stage holds (K unless a row exceeds a stage)
  int n_chunks;
  int stage_bytes;  // one stage, a multiple of 128
  int cov_bytes;    // two buffers of a tile's packed covariances
  int steer_bytes;  // steering staged in shared memory (0: read from global)
  int smem_bytes;   // dynamic shared memory of a block
  int bulk;         // 1: TMA bulk copies; 0: 8-byte cp.async
  long long tiles;
};

__host__ __device__ inline Geometry make_geometry(long long rows, int n_ant, int k_len,
                                                  int m_len, bool aligned) {
  Geometry g;
  const long long row_bytes = 8LL * n_ant * k_len;
  if (row_bytes <= kStageCap) {
    g.chunk = k_len;
    g.tile_rows = static_cast<int>(lmin(kMaxTileRows, kStageCap / row_bytes));
  } else {
    // even, so that the chunks of an even K start and end on 16 bytes
    g.chunk = static_cast<int>(lmax(2, (kStageCap / (8 * n_ant)) & ~1));
    g.tile_rows = 1;
  }
  g.tile_rows = static_cast<int>(lmin(g.tile_rows, lmax(1, cdiv(rows, kMinTiles))));
  g.n_chunks = static_cast<int>(cdiv(k_len, g.chunk));
  g.tiles = cdiv(rows, g.tile_rows);
  g.stage_bytes = static_cast<int>(cdiv(8LL * g.tile_rows * n_ant * g.chunk, 128) * 128);
  g.cov_bytes = 2 * g.tile_rows * (n_ant * (n_ant + 1) / 2) * 8;
  const long long steer = 8LL * n_ant * m_len;
  const long long base = kBarBytes + kStages * static_cast<long long>(g.stage_bytes) + g.cov_bytes;
  g.steer_bytes = (steer <= kSteerCap && base + steer <= kSmemMax) ? static_cast<int>(steer) : 0;
  g.smem_bytes = static_cast<int>(base + g.steer_bytes);
  g.bulk = (k_len % 2 == 0) && aligned;
  return g;
}

// One copy of a stage's fill: `len` complex elements from x + src to stage + dst.
struct Run {
  long long src;
  long long len;
  long long dst;
};

// The rows [r0, r0 + n) of a tile, chirps [k0, k0 + kc).  The stage holds, for
// each frame the tile touches, that frame's rows as [A][rows][kc]; a run of
// whole frames ([frames][A][W][K] in x) is copied as one run.
struct TilePlan {
  long long b0;  // frame of the first row
  int w0;        // its range bin
  int n_head;    // rows of a partly covered first frame (0: it is whole)
  int n_whole;   // whole frames after it
  int n_tail;    // rows of a partly covered last frame
};

__host__ __device__ inline TilePlan plan_tile(long long r0, int n, int w_len, int kc, int k_len) {
  TilePlan p;
  p.b0 = r0 / w_len;
  p.w0 = static_cast<int>(r0 % w_len);
  const bool whole_rows = kc == k_len;  // else n == 1: one row, one chunk
  p.n_head = (p.w0 > 0 || n < w_len || !whole_rows)
                 ? static_cast<int>(lmin(n, w_len - p.w0)) : 0;
  const int rest = n - p.n_head;
  p.n_whole = rest / w_len;
  p.n_tail = rest % w_len;
  return p;
}

__host__ __device__ inline int plan_runs(const TilePlan& p, int n_ant) {
  return (p.n_head ? n_ant : 0) + (p.n_whole ? 1 : 0) + (p.n_tail ? n_ant : 0);
}

// The r-th run of a tile (r < plan_runs).
__host__ __device__ inline Run plan_run(const TilePlan& p, int n_ant, int w_len, int k_len,
                                        int k0, int kc, int r) {
  const long long frame = static_cast<long long>(n_ant) * w_len * k_len;
  const int head_runs = p.n_head ? n_ant : 0;
  const long long b1 = p.b0 + (p.n_head ? 1 : 0);  // first whole frame
  Run run;
  if (r < head_runs) {
    run.src = ((p.b0 * n_ant + r) * w_len + p.w0) * k_len + k0;
    run.len = static_cast<long long>(p.n_head) * kc;
    run.dst = r * run.len;
  } else if (r == head_runs && p.n_whole) {
    run.src = b1 * frame;
    run.len = p.n_whole * frame;
    run.dst = static_cast<long long>(p.n_head) * n_ant * kc;
  } else {
    const int i = r - head_runs - (p.n_whole ? 1 : 0);
    run.src = ((b1 + p.n_whole) * n_ant + i) * static_cast<long long>(w_len) * k_len;
    run.len = static_cast<long long>(p.n_tail) * k_len;
    run.dst = (static_cast<long long>(p.n_head) + static_cast<long long>(p.n_whole) * w_len) *
                  n_ant * kc + i * run.len;
  }
  return run;
}

struct Args {
  const float2* x;
  const float2* steer;
  float* out;
  long long rows;  // B * W
  int w_len;
  int k_len;
  int m_len;
  float loading;
  float inv_k;
  Geometry geo;
};

// a * conj(b)
__device__ __forceinline__ float2 mul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA 1D bulk copy global -> shared; completes `bytes` on the mbarrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void copy8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// one arrival on the mbarrier once this thread's cp.async copies have landed
__device__ __forceinline__ void copy8_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// packed lower triangle: entry (i, j), j <= i
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// The block's item `item` (tile blockIdx.x + (item / n_chunks) * gridDim.x,
// chunk item % n_chunks) into `stage`.
__device__ __forceinline__ void fill_stage(const Args& args, int n_ant, long long item,
                                           float2* stage, uint64_t* bar) {
  const Geometry& geo = args.geo;
  const long long tile = blockIdx.x + (item / geo.n_chunks) * gridDim.x;
  const int k0 = static_cast<int>(item % geo.n_chunks) * geo.chunk;
  const int kc = static_cast<int>(lmin(geo.chunk, args.k_len - k0));
  const long long r0 = tile * geo.tile_rows;
  const int n = static_cast<int>(lmin(geo.tile_rows, args.rows - r0));
  const TilePlan plan = plan_tile(r0, n, args.w_len, kc, args.k_len);
  const int n_runs = plan_runs(plan, n_ant);
  if (geo.bulk) {
    if (threadIdx.x >= 32) return;
    if (threadIdx.x == 0) mbar_expect_tx(bar, static_cast<unsigned>(8LL * n * n_ant * kc));
    __syncwarp();
    for (int r = threadIdx.x; r < n_runs; r += 32) {
      const Run run = plan_run(plan, n_ant, args.w_len, args.k_len, k0, kc, r);
      bulk_copy(stage + run.dst, args.x + run.src, static_cast<unsigned>(8 * run.len), bar);
    }
  } else {
    for (int r = 0; r < n_runs; ++r) {
      const Run run = plan_run(plan, n_ant, args.w_len, args.k_len, k0, kc, r);
      for (long long e = threadIdx.x; e < run.len; e += kThreads)
        copy8(stage + run.dst + e, args.x + run.src + e);
    }
    copy8_arrive(bar);
  }
}

// Entries [P0, P1) of this row's covariance over chirps k = g, g + 8, ... < kc of
// the stage (antenna i's samples at xs + i * a_stride), summed over the group and
// added to cov (stored on the first chunk) by the group's first thread.
template <int A, int P0, int P1>
__device__ __forceinline__ void covariance_pass(const float2* xs, int a_stride, int kc, int g,
                                                float2* cov, bool first) {
  float2 acc[P1 - P0];
#pragma unroll
  for (int e = 0; e < P1 - P0; ++e) acc[e] = make_float2(0.0f, 0.0f);
  for (int k = g; k < kc; k += kGroup) {
    float2 v[A];
#pragma unroll
    for (int i = 0; i < A; ++i) v[i] = xs[i * a_stride + k];
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const int e = tri(i, j);
        if (e < P0 || e >= P1) continue;
        if (j == i) {
          acc[e - P0].x += v[i].x * v[i].x + v[i].y * v[i].y;
        } else {
          const float2 p = mul_conj(v[i], v[j]);
          acc[e - P0].x += p.x;
          acc[e - P0].y += p.y;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < P1 - P0; ++e) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      acc[e].x += __shfl_xor_sync(kFullMask, acc[e].x, off);
      acc[e].y += __shfl_xor_sync(kFullMask, acc[e].y, off);
    }
  }
  if (g == 0 && cov != nullptr) {
#pragma unroll
    for (int e = 0; e < P1 - P0; ++e) {
      if (first) {
        cov[P0 + e] = acc[e];
      } else {
        cov[P0 + e].x += acc[e].x;
        cov[P0 + e].y += acc[e].y;
      }
    }
  }
}

template <int A, int P0 = 0>
__device__ __forceinline__ void covariance(const float2* xs, int a_stride, int kc, int g,
                                           float2* cov, bool first) {
  constexpr int kEntries = A * (A + 1) / 2;
  constexpr int P1 = P0 + kEntryPass < kEntries ? P0 + kEntryPass : kEntries;
  covariance_pass<A, P0, P1>(xs, a_stride, kc, g, cov, first);
  if constexpr (P1 < kEntries) covariance<A, P1>(xs, a_stride, kc, g, cov, first);
}

// Scale the packed sums by 1/K; for Capon then load the diagonal, factor
// R' = L L^H and invert L, all in place: c holds R (Bartlett) or L^-1 (Capon).
// `c` is a register array (A <= 8) or the row's shared memory.
template <int A, bool kCapon, typename Tri>
__device__ __forceinline__ void finish_row(Tri c, float inv_k, float loading) {
#pragma unroll
  for (int e = 0; e < A * (A + 1) / 2; ++e) c[e] = make_float2(c[e].x * inv_k, c[e].y * inv_k);
  if constexpr (kCapon) {
    float tr = 0.0f;
#pragma unroll
    for (int i = 0; i < A; ++i) tr += c[tri(i, i)].x;
    const float load = loading * tr / A + 1e-12f;
#pragma unroll
    for (int i = 0; i < A; ++i) c[tri(i, i)] = make_float2(c[tri(i, i)].x + load, 0.0f);
    float inv_d[A];
    // Cholesky, column by column; column j reads columns < j of L only
#pragma unroll
    for (int j = 0; j < A; ++j) {
      float s = c[tri(j, j)].x;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        const float2 l = c[tri(j, k)];
        s -= l.x * l.x + l.y * l.y;
      }
      const float d = sqrtf(fmaxf(s, kTiny));
      inv_d[j] = 1.0f / d;
#pragma unroll
      for (int i = j + 1; i < A; ++i) {
        float2 t = c[tri(i, j)];
#pragma unroll
        for (int k = 0; k < j; ++k) {
          const float2 p = mul_conj(c[tri(i, k)], c[tri(j, k)]);
          t.x -= p.x;
          t.y -= p.y;
        }
        c[tri(i, j)] = make_float2(t.x * inv_d[j], t.y * inv_d[j]);
      }
      c[tri(j, j)] = make_float2(d, 0.0f);
    }
    // L^-1 in place, column by column (forward substitution on the identity):
    // column j reads L's columns >= j and L^-1's column j above row i
#pragma unroll
    for (int j = 0; j < A; ++j) {
      c[tri(j, j)] = make_float2(inv_d[j], 0.0f);
#pragma unroll
      for (int i = j + 1; i < A; ++i) {
        const float2 lij = c[tri(i, j)];
        float2 s = make_float2(lij.x * inv_d[j], lij.y * inv_d[j]);
#pragma unroll
        for (int k = j + 1; k < i; ++k) {
          const float2 l = c[tri(i, k)];
          const float2 v = c[tri(k, j)];
          s.x += l.x * v.x - l.y * v.y;
          s.y += l.x * v.y + l.y * v.x;
        }
        c[tri(i, j)] = make_float2(-s.x * inv_d[i], -s.y * inv_d[i]);
      }
    }
  }
}

template <int A, bool kCapon>
__device__ __forceinline__ float power(const float2* c, const float2 (&a)[A]) {
  float p = 0.0f;
  if constexpr (kCapon) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      float2 g = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const float2 v = c[tri(i, j)];
        g.x += v.x * a[j].x - v.y * a[j].y;
        g.y += v.x * a[j].y + v.y * a[j].x;
      }
      p += g.x * g.x + g.y * g.y;
    }
    return 1.0f / fmaxf(p, kTiny);
  } else {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      p += (a[i].x * a[i].x + a[i].y * a[i].y) * c[tri(i, i)].x;
#pragma unroll
      for (int j = 0; j < i; ++j) {
        const float2 w = mul_conj(a[j], a[i]);  // conj(a_i) a_j
        const float2 r = c[tri(i, j)];
        p += 2.0f * (r.x * w.x - r.y * w.y);
      }
    }
    return p;
  }
}

template <int A, bool kCapon>
__global__ void __launch_bounds__(kThreads) beamform_kernel(const Args args) {
  constexpr int kEntries = A * (A + 1) / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry& geo = args.geo;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float2* stages = reinterpret_cast<float2*>(smem + kBarBytes);
  const int stage_len = geo.stage_bytes / 8;
  float2* cov_buf = stages + kStages * stage_len;
  float2* s_steer = cov_buf + geo.cov_bytes / 8;
  const int tid = threadIdx.x;
  const int q = tid / kGroup;  // the group's row within a tile
  const int g = tid % kGroup;
  const int m_len = args.m_len;

  const long long my_tiles =
      geo.tiles > blockIdx.x ? cdiv(geo.tiles - blockIdx.x, gridDim.x) : 0;
  const long long n_items = my_tiles * geo.n_chunks;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], geo.bulk ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const float2* steer = args.steer;
  if (geo.steer_bytes) {
    for (int e = tid; e < A * m_len; e += kThreads) s_steer[e] = __ldg(&args.steer[e]);
    steer = s_steer;
  }
  __syncthreads();
  for (int s = 0; s < kStages && s < n_items; ++s)
    fill_stage(args, A, s, stages + s * stage_len, &full[s]);

  // the (row, m) pairs of a thread step by kThreads: row by d_row, m by d_m
  const int d_row = kThreads / m_len, d_m = kThreads % m_len;
  int m_loaded = -1;
  float2 a[A];
  for (long long item = 0; item < n_items; ++item) {
    const int s = static_cast<int>(item % kStages);
    const long long tile_no = item / geo.n_chunks;
    const int chunk = static_cast<int>(item % geo.n_chunks);
    const long long r0 = (blockIdx.x + tile_no * gridDim.x) * geo.tile_rows;
    const int n = static_cast<int>(lmin(geo.tile_rows, args.rows - r0));
    const int k0 = chunk * geo.chunk;
    const int kc = static_cast<int>(lmin(geo.chunk, args.k_len - k0));
    const bool last = chunk == geo.n_chunks - 1;
    float2* cov = cov_buf + (tile_no & 1) * geo.tile_rows * kEntries;
    mbar_wait(&full[s], static_cast<unsigned>((item / kStages) & 1));

    // this group's row: its frame's rows of the tile are [seg0, seg1), laid
    // out in the stage as [A][seg1 - seg0][kc] from (seg0 - r0) * A * kc
    const bool active = q < n;
    const long long row = r0 + (active ? q : 0);
    const long long b = row / args.w_len;
    const long long seg0 = lmax(r0, b * args.w_len);
    const long long seg1 = lmin(r0 + n, (b + 1) * args.w_len);
    const float2* xs = stages + s * stage_len + (seg0 - r0) * A * kc + (row - seg0) * kc;
    const int a_stride = static_cast<int>(seg1 - seg0) * kc;
    float2* cov_row = active ? cov + q * kEntries : nullptr;
    covariance<A>(xs, a_stride, active ? kc : 0, g, cov_row, chunk == 0);
    if (last && active && g == 0) {
      if constexpr (kEntries <= kEntryPass) {
        float2 c[kEntries];
#pragma unroll
        for (int e = 0; e < kEntries; ++e) c[e] = cov_row[e];
        finish_row<A, kCapon>(c, args.inv_k, args.loading);
#pragma unroll
        for (int e = 0; e < kEntries; ++e) cov_row[e] = c[e];
      } else {
        finish_row<A, kCapon>(cov_row, args.inv_k, args.loading);
      }
    }
    // every thread has read stage s, and every row of the tile is finished
    __syncthreads();
    if (item + kStages < n_items) fill_stage(args, A, item + kStages, stages + s * stage_len, &full[s]);
    if (!last) continue;

    const int pairs = n * m_len;
    int row_l = tid / m_len, m = tid % m_len;
    float* out = args.out + r0 * m_len;
    for (int e = tid; e < pairs; e += kThreads) {
      if (m != m_loaded) {
#pragma unroll
        for (int j = 0; j < A; ++j) a[j] = steer[j * m_len + m];
        m_loaded = m;
      }
      out[e] = power<A, kCapon>(cov + row_l * kEntries, a);
      row_l += d_row;
      m += d_m;
      if (m >= m_len) {
        m -= m_len;
        ++row_l;
      }
    }
  }
}

template <bool kCapon, int A = 1>
int dispatch(int n_ant, const Args& args, cudaStream_t stream) {
  if constexpr (A > kMaxAntennas) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (n_ant != A) return dispatch<kCapon, A + 1>(n_ant, args, stream);
    auto kernel = beamform_kernel<A, kCapon>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, args.geo.smem_bytes);
    int device = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                          args.geo.smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    // persistent blocks: as many as fit on the card at once, each walking its tiles
    const long long blocks = lmax(1, lmin(args.geo.tiles, static_cast<long long>(per_sm) * sms));
    kernel<<<static_cast<unsigned int>(blocks), kThreads, args.geo.smem_bytes, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
}

bool valid_shape(int n_ant, int w_len, int k_len) {
  return n_ant >= 1 && n_ant <= kMaxAntennas && w_len >= 1 && k_len >= 1;
}

template <bool kCapon>
int run(const void* x, const void* steer, void* out, int rows, int n_ant, int w_len,
        int k_len, int m_len, float loading, void* stream) {
  if (rows <= 0 || m_len <= 0) return 0;
  if (!valid_shape(n_ant, w_len, k_len)) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Args args = {static_cast<const float2*>(x),
                     static_cast<const float2*>(steer),
                     static_cast<float*>(out),
                     rows,
                     w_len,
                     k_len,
                     m_len,
                     loading,
                     1.0f / static_cast<float>(k_len),
                     make_geometry(rows, n_ant, k_len, m_len, aligned)};
  return dispatch<kCapon>(n_ant, args, static_cast<cudaStream_t>(stream));
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

// The launch geometry of a shape, host side, for comparison with the Python
// model (ops/kernels/beamform.py launch_geometry): out[0..8] = tile_rows,
// chunk, n_chunks, stage_bytes, cov_bytes, steer_bytes, smem_bytes, bulk,
// tiles.  Returns cudaErrorInvalidValue on a shape the kernels do not take.
extern "C" int beamform_geometry(long long rows, int n_ant, int k_len, int m_len, int aligned,
                                 long long* out) {
  if (rows <= 0 || m_len <= 0 || !valid_shape(n_ant, 1, k_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(rows, n_ant, k_len, m_len, aligned != 0);
  const long long fields[] = {g.tile_rows,  g.chunk,      g.n_chunks, g.stage_bytes, g.cov_bytes,
                              g.steer_bytes, g.smem_bytes, g.bulk,     g.tiles};
  for (int i = 0; i < 9; ++i) out[i] = fields[i];
  return 0;
}

// The copies that fill a stage with chunk `chunk` of tile `tile`, host side:
// out[3 r .. 3 r + 2] = src, len, dst (complex elements) of run r.  Returns
// the number of runs (at most 2 * n_ant + 1), or -1 on a shape or an item
// outside the geometry.
extern "C" int beamform_tile_runs(long long rows, int n_ant, int w_len, int k_len, int m_len,
                                  long long tile, int chunk, long long* out) {
  if (rows <= 0 || m_len <= 0 || !valid_shape(n_ant, w_len, k_len)) return -1;
  const Geometry g = make_geometry(rows, n_ant, k_len, m_len, true);
  if (tile < 0 || tile >= g.tiles || chunk < 0 || chunk >= g.n_chunks) return -1;
  const int k0 = chunk * g.chunk;
  const int kc = static_cast<int>(lmin(g.chunk, k_len - k0));
  const long long r0 = tile * g.tile_rows;
  const int n = static_cast<int>(lmin(g.tile_rows, rows - r0));
  const TilePlan plan = plan_tile(r0, n, w_len, kc, k_len);
  const int n_runs = plan_runs(plan, n_ant);
  for (int r = 0; r < n_runs; ++r) {
    const Run run = plan_run(plan, n_ant, w_len, k_len, k0, kc, r);
    out[3 * r] = run.src;
    out[3 * r + 1] = run.len;
    out[3 * r + 2] = run.dst;
  }
  return n_runs;
}
