// Device code shared by the two tiled rasterizers, fused_raster.cu and
// zbuffer.cu (sm_90a): the tile and warp geometry, the rounded affine
// evaluation, the conservative rejection of a face for a warp's pixel
// rectangle, and the mbarrier ring that whole chunks of the face table land
// in by cp.async.bulk.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace raster {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kConsumers = 256;           // 8 warps a tile, 4 pixels a thread
constexpr int kThreads = kConsumers + 32; // + one producer warp
constexpr int kPix = 4;
constexpr int kMaxStages = 4;             // ring of chunks in shared memory
constexpr float kNegEps = -1e-7f;         // the inside test: e >= -1e-7
// Rejection margin, as a fraction of S = |a| X + |b| Y + |c| (X, Y: the
// largest pixel-centre coordinates of the rectangle).  See edge_fails.
constexpr float kMarginScale = 1.0f / (1 << 20);

// Warp w of a tile covers the pixels x in 32 (w % 4) .. + 31 (one a lane)
// and y in 4 (w / 4) .. + 3 (one a step of the thread's pixel loop): a
// rectangle of 32 x 4 pixels, so that a face touches few warps of a tile
// and a row of a warp's stores is one coalesced 128-byte segment.
struct WarpRect {
  float xa, xb, ya, yb;                   // pixel-centre corners, tile-local
};

__device__ __forceinline__ WarpRect warp_rect(int warp) {
  WarpRect r;
  r.xa = (float)(32 * (warp & 3)) + 0.5f;
  r.xb = r.xa + 31.0f;
  r.ya = (float)(4 * (warp >> 2)) + 0.5f;
  r.yb = r.ya + 3.0f;
  return r;
}

__device__ __forceinline__ float affine(float ax, float b, float c, float py) {
  // (a * px + b * py) + c with ax = a * px already rounded.
  return __fadd_rn(__fadd_rn(ax, __fmul_rn(b, py)), c);
}

// True when the edge function e = (a px + b py) + c, as the kernels round
// it, is below -1e-7 at every pixel centre of the rectangle, so that no
// pixel there can pass the inside test.  The exact affine E has its maximum
// over the rectangle at a corner: Emax = (max(a xa, a xb) + max(b ya, b yb))
// + c.  Let u = 2^-24 and S = |a| xb + |b| yb + |c| (the coordinates are
// positive).  The rounded e at a pixel is within 3.01 u S of E there (three
// roundings: two products, each within u of a term bounded by S, and two
// sums whose results are bounded by (1 + u)^2 S), and the rounded corner
// value m is within 3.01 u S of Emax by the same count (rounding is
// monotone, so fmaxf of the rounded products is the rounded maximum).  So
// e <= m + 6.02 u S everywhere in the rectangle, and m + 6.02 u S rounds
// to at most m + 7.1 u S.  The margin is 2^-20 S = 16 u S, more than twice
// that: if m + 2^-20 S < -1e-7, then e < -1e-7 at every pixel.  S rounds
// to within 3 u of itself, which the factor absorbs.  A NaN anywhere makes
// the comparison false (kept); an infinite coefficient makes S infinite
// and the sum +inf or NaN (kept).  Sentinel slots (a = b = 0, c = -1) are
// always rejected.
__device__ __forceinline__ bool edge_fails(float a, float b, float c,
                                           const WarpRect& r) {
  const float m = __fadd_rn(
      __fadd_rn(fmaxf(__fmul_rn(a, r.xa), __fmul_rn(a, r.xb)),
                fmaxf(__fmul_rn(b, r.ya), __fmul_rn(b, r.yb))),
      c);
  const float s = __fadd_rn(
      __fadd_rn(__fmul_rn(fabsf(a), r.xb), __fmul_rn(fabsf(b), r.yb)),
      fabsf(c));
  return __fadd_rn(m, __fmul_rn(s, kMarginScale)) < kNegEps;
}

// ---- mbarriers and bulk copies (the async proxy writes, complete_tx)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// Spins until the phase of parity `phase` has completed; a wait that
// outlasts some seconds means a broken schedule: trap (the launch then
// fails with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One contiguous global -> shared copy (16-byte aligned, a multiple of 16
// bytes), completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The ring: `stages` slots of `bytes` each, a full and an empty barrier a
// slot.  One producer lane issues chunk i into slot i % stages once the 8
// consumer warps have released the chunk that held it (i - stages); the
// consumers wait for chunk i's bytes, read it, and release it.
struct Ring {
  uint32_t base, bars;
  int stages, bytes;

  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (kMaxStages + s);
  }
  __device__ __forceinline__ uint32_t slot(int i) const {
    return base + (i % stages) * bytes;
  }
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);                       // the expect_tx arrival
      mbar_init(empty(s), kConsumers / 32);        // every consumer warp
    }
    fence_barrier_init();
  }
  // producer lane: chunk i from `src` into its slot
  __device__ __forceinline__ void put(int i, const void* src) const {
    const int s = i % stages;
    if (i >= stages) mbar_wait(empty(s), ((i / stages) - 1) & 1);
    mbar_expect_tx(full(s), bytes);
    bulk_copy(slot(i), src, bytes, full(s));
  }
  // consumer warp: wait for chunk i / release it
  __device__ __forceinline__ void take(int i) const {
    mbar_wait(full(i % stages), (i / stages) & 1);
  }
  __device__ __forceinline__ void release(int i, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i % stages));
  }
};

// Shared memory of a block: the ring, then the barriers, then the tile's
// keys for the cluster's combine.  -> bytes.
constexpr int kBarBytes = 2 * kMaxStages * 8;
__host__ __device__ inline int ring_bytes(int chunk_bytes, int stages) {
  return stages * chunk_bytes;
}
__host__ __device__ inline int smem_bytes(int chunk_bytes, int stages) {
  return ring_bytes(chunk_bytes, stages) + kBarBytes + kTileH * kTileW * 4;
}

// Chunks in the ring: as many of 4 as fit in 96 KB, and at least 2.
__host__ inline int ring_stages(int chunk_bytes) {
  int s = 98304 / chunk_bytes;
  return s < 2 ? 2 : (s > kMaxStages ? kMaxStages : s);
}

// Chunks [begin, end) of a tile, split over the `ranks` blocks of a cluster:
// block `rank` walks begin + rank, begin + rank + ranks, ...  -> its count.
__device__ __forceinline__ int rank_chunks(int begin, int end, int rank,
                                           int ranks) {
  const int n = end - begin - rank;
  return n > 0 ? (n + ranks - 1) / ranks : 0;
}

// Launches `kernel` over grid (tiles x cluster, frames) with clusters of
// `cluster` blocks along x (no cluster attribute for 1).
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), int tiles, int frames,
                     int cluster, int smem, cudaStream_t stream,
                     Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, frames, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace raster
