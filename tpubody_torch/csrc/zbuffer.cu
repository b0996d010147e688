// zbuffer: tiled z-buffer rasterization (coverage + packed depth/face key,
// no attributes), one cluster of thread blocks per (frame, 8x128-pixel
// tile), for Hopper (sm_90a).
//
// Replaces: tpubody/render/pallas_raster.py::_raster_kernel (the Pallas TPU
// kernel launched by zbuffer_tiled, behind rasterize_tiled).  It computes
// the same function; the TPU's shape is not carried over: no (640, 4) x
// (4, 1024) coefficient product (an affine function of two pixel
// coordinates is two multiplies and two adds a pixel, nothing for the
// tensor cores), no (128, 1024) accumulator with a final minimum across
// faces, no (B, T, 1, 1024) output that a second pass re-lays to the image.
//
// Inputs (built by tpubody_torch/render/tiled_raster.py::bin_faces):
//   table   (B, T, NC, 5 * 128, 4) f32: per tile NC chunks of 128 faces;
//           a chunk is five groups of 128 rows [e0, e1, e2, zq, fid], each
//           row (a, b, c, 0) with value(px, py) = (a * px + b * py) + c at
//           TILE-LOCAL pixel centres (the constants were evaluated at the
//           tile origin); fid is carried in its c; unused slots are
//           sentinel faces whose edge constants are -1;
//   nchunks (B, T) i32: tile t of frame b reads its first nchunks[b, t]
//           chunks.
// Output, in image layout:
//   zbuf (B, H, W) i32: min over the covering faces of (dq << fb) | fid,
//        dq = (int)clamp(zq, 0, zcap); INT32_MAX where nothing covers.
//
// Arithmetic: every affine value is __fadd_rn(__fadd_rn(__fmul_rn(a, px),
// __fmul_rn(b, py)), c), no fused multiply-add, so the plain PyTorch
// version (separate float32 multiplies and adds in the same order) gives
// the same bits and the inside test e >= -1e-7 decides the same pixels.
// The shift of dq is taken in unsigned arithmetic and reinterpreted: for
// meshes under 64 faces zcap rounds up to 2^(31 - fb) and the key wraps,
// exactly as in the Pallas kernel.
//
// What bounds it on an H100 SXM (data sheet: 3.35 TB/s HBM, 67 TFLOP/s
// fp32): the 4 bytes a pixel it writes and the live chunks it reads (10 KB
// each), about 8 MB for the body maps at 1024^2: 2.3 us.  Evaluating every
// pair of a real face and a pixel of its tile (about 13 operations each)
// would take longer than that at the fp32 rate, and twice as long as the
// unfused instructions issue; the pairs a face's triangle can reach are a
// small share of them.
//
// What the design does about it, as in fused_raster.cu (the shared parts
// are in raster_common.cuh): each of the 8 consumer warps owns a 32 x 4
// pixel rectangle and, per group of 32 faces, keeps by one ballot only the
// faces that can reach it (edge_fails, a conservative corner test); whole
// 10 KB chunks land by cp.async.bulk in a ring of 4 slots, filled by one
// producer lane; the blocks of a cluster split a tile's chunks (block r
// walks r, r + k, ...) and block 0 combines their keys per pixel through
// distributed shared memory and writes the tile.  The evaluation stops at
// the tile's last real face: the sentinel slots after it fail every warp's
// test (their edges are the constant -1), so no ballot holds them, and a
// chunk of sentinels costs one test a lane a group.  A minimum of keys
// does not depend on the order of the walk: the same bits as one block.
// An empty tile takes a short path: block 0 writes INT32_MAX and every
// block of its cluster leaves without the ring or a cluster barrier.
//
// The wrapper allocates the output; the kernel runs on the caller's
// stream, allocates nothing, synchronises nothing, and the entry point
// returns the launch's error.
#include "raster_common.cuh"

namespace {

using namespace raster;
namespace cg = cooperative_groups;

constexpr int kCF = 128;                  // faces per chunk
constexpr int kRows = 5 * kCF;            // float4 rows per chunk

__global__ void __launch_bounds__(kThreads)
zbuffer_kernel(const float4* __restrict__ table,   // (B, T, NC, 640)
               const int* __restrict__ nchunks,    // (B, T)
               int* __restrict__ zbuf,             // (B, H, W)
               int H, int W, int NC, int fb, float zcap, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int TX = W / kTileW;
  const int T = TX * (H / kTileH);
  const int t = blockIdx.x / ranks;
  const int b = blockIdx.y;
  const size_t cell = (size_t)b * T + t;
  const int total = min(max(nchunks[cell], 0), NC);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lx = 32 * (warp & 3) + lane;
  const int ly = 4 * (warp >> 2);
  const int x = (t % TX) * kTileW + lx;
  const int y0 = (t / TX) * kTileH + ly;
  int* out = zbuf + (size_t)b * H * W;
  if (total == 0) {
    // An empty tile (80% of the body maps'): block 0 writes INT32_MAX,
    // every block of the cluster leaves at once.
    if (rank == 0 && warp < kConsumers / 32)
#pragma unroll
      for (int k = 0; k < kPix; ++k) out[(size_t)(y0 + k) * W + x] = INT_MAX;
    return;
  }
  const int n = rank_chunks(0, total, rank, ranks);
  const float4* tab = table + cell * NC * kRows;
  Ring ring;
  ring.base = smem_u32(smem);
  ring.stages = stages;
  ring.bytes = kRows * 16;
  ring.bars = ring.base + ring_bytes(ring.bytes, stages);
  int* keys = reinterpret_cast<int*>(smem + ring_bytes(ring.bytes, stages) +
                                     kBarBytes);
  const float4* slots = reinterpret_cast<const float4*>(smem);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const float px = (float)lx + 0.5f;
  int best[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) best[k] = INT_MAX;

  if (warp == kConsumers / 32) {
    // ================= producer: one lane copies this block's chunks
    if (lane == 0)
      for (int i = 0; i < n; ++i)
        ring.put(i, tab + (size_t)(rank + i * ranks) * kRows);
  } else {
    // ================= consumers
    const WarpRect rect = warp_rect(warp);
    for (int i = 0; i < n; ++i) {
      ring.take(i);
      const float4* coef = slots + (i % stages) * kRows;
#pragma unroll 1
      for (int g0 = 0; g0 < kCF; g0 += 32) {
        const float4 t0 = coef[g0 + lane];
        const float4 t1 = coef[kCF + g0 + lane];
        const float4 t2 = coef[2 * kCF + g0 + lane];
        unsigned live = __ballot_sync(
            0xffffffffu, !(edge_fails(t0.x, t0.y, t0.z, rect) ||
                           edge_fails(t1.x, t1.y, t1.z, rect) ||
                           edge_fails(t2.x, t2.y, t2.z, rect)));
        while (live) {
          const int f = g0 + __ffs(live) - 1;
          live &= live - 1;
          const float4 q0 = coef[f];
          const float4 q1 = coef[kCF + f];
          const float4 q2 = coef[2 * kCF + f];
          const float a0x = __fmul_rn(q0.x, px);
          const float a1x = __fmul_rn(q1.x, px);
          const float a2x = __fmul_rn(q2.x, px);
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const float py = (float)(ly + k) + 0.5f;
            const float e0 = affine(a0x, q0.y, q0.z, py);
            const float e1 = affine(a1x, q1.y, q1.z, py);
            const float e2 = affine(a2x, q2.y, q2.z, py);
            if (e0 >= kNegEps && e1 >= kNegEps && e2 >= kNegEps) {
              const float4 qz = coef[3 * kCF + f];
              const float zq = affine(__fmul_rn(qz.x, px), qz.y, qz.z, py);
              const int dq = (int)fminf(fmaxf(zq, 0.0f), zcap);
              const int key = (int)(((unsigned)dq << fb) |
                                    (unsigned)(int)coef[4 * kCF + f].z);
              best[k] = min(best[k], key);
            }
          }
        }
      }
      ring.release(i, lane);
    }
  }

  // ---- the combine: block 0 takes the cluster's minimum and writes it
  const bool consumer = warp < kConsumers / 32;
  if (ranks > 1) {
    if (consumer)
#pragma unroll
      for (int k = 0; k < kPix; ++k) keys[(ly + k) * kTileW + lx] = best[k];
    cluster.sync();
  }
  if (consumer && rank == 0) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      int key = best[k];
      for (int r = 1; r < ranks; ++r)
        key = min(key,
                  cluster.map_shared_rank(keys, r)[(ly + k) * kTileW + lx]);
      out[(size_t)(y0 + k) * W + x] = key;
    }
  }
  if (ranks > 1) cluster.sync();        // no block leaves while read
}

}  // namespace

// Launches the kernel on `stream` over grid (tiles x cluster, frames), in
// clusters of `cluster` blocks (1 or 2), and returns the launch's
// error.  H must be a multiple of 8 and W of 128, and the table 16-byte
// aligned (the wrapper checks); zcap = float(depth_levels - 1).
extern "C" int tpubody_zbuffer(const float* table, const int* nchunks,
                               int* zbuf, int B, int H, int W, int NC, int fb,
                               float zcap, int cluster, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (cluster != 1 && cluster != 2)
    return (int)cudaErrorInvalidValue;
  const int T = (W / kTileW) * (H / kTileH);
  const int stages = kMaxStages;
  return launch_clustered(zbuffer_kernel, T, B, cluster,
                          smem_bytes(kRows * 16, stages), stream,
                          reinterpret_cast<const float4*>(table), nchunks,
                          zbuf, H, W, NC, fb, zcap, stages);
}
