// fused_raster: tiled triangle rasterization fused with attribute
// interpolation, one cluster of thread blocks per (frame, 8x128-pixel
// tile), for Hopper (sm_90a).
//
// Replaces: tpubody/render/pallas_raster.py::_fused_kernel (the Pallas TPU
// kernel behind tpubody.render.pallas_raster.render_attrs_tiled, launched
// by _fused_call).  It computes the same function; what in the Pallas
// kernel is the TPU's shape is not carried over: the (4, 1024) pixel
// matrix and the coefficient matmul (an affine function of two pixel
// coordinates is two multiply-adds per pixel; the tensor cores have
// nothing to do here), the zero fourth column, the lane padding to 128,
// the 16-chunk copies with their zero tail chunks, the channel padding to
// 8, and the select-sum over all faces of a chunk that picks the winner's
// attributes.
//
// Inputs (built by tpubody_torch/render/tiled_raster.py::_bin_fused):
//   table  (B, MAXC, CF, G, 3) f32, G = 5 + C groups per face:
//          [e0, e1, e2, zq, fid, attr_0 .. attr_{C-1}], each (a, b, c) with
//          value(px, py) = (a * px + b * py) + c at TILE-LOCAL pixel
//          centres (the constants were evaluated at the tile origin);
//          fid is carried in its c; partial chunks are filled with
//          sentinel faces whose edge constants are -1;
//   starts (B, T + 1) i32: tile t of frame b owns chunks
//          [starts[b, t], starts[b, t + 1]).
// Outputs, in image layout (no detile pass):
//   win  (B, H, W) i32: min over the covering faces of (dq << fb) | fid,
//        dq = (int)clamp(zq, 0, zcap); INT32_MAX where nothing covers;
//   attr (B, C, H, W) f32: the winner's attribute planes, 0 elsewhere.
//
// Arithmetic: every affine value is __fadd_rn(__fadd_rn(__fmul_rn(a, px),
// __fmul_rn(b, py)), c): no fused multiply-add, so the plain PyTorch
// version (separate float32 multiplies and adds in the same order) gives
// the same bits, and the inside test e >= -1e-7 decides the same pixels.
// The shift of dq is taken in unsigned arithmetic and reinterpreted: for
// small meshes zcap rounds up to 2^(31 - fb) and the key wraps, exactly as
// in the Pallas kernel.
//
// What bounds it on an H100 SXM (data sheet: 3.35 TB/s HBM, 67 TFLOP/s
// fp32): the output planes, (1 + C) x 4 bytes a pixel of every frame, and
// the table's real chunks, read once: 156 MB for the video's base pass
// (B = 8, 1024^2, C = 3), 0.047 ms.  The operations that these inputs need
// are the pairs of a face and a pixel that the face's triangle can reach:
// evaluating every pair of a tile (32 faces x 1,024 pixels a chunk, about
// 13 operations each) would take 0.046 ms at the fp32 rate, and twice that
// as the instructions issue, because the arithmetic is unfused by design
// (the 67 TFLOP/s count a fused multiply-add as two operations).  So the
// design must evaluate fewer pairs.
//
// What the design does about it:
//   * Warp-level rejection.  Each of the 8 consumer warps owns a 32 x 4
//     pixel rectangle of the tile (raster_common.cuh).  Per chunk, lane l
//     of a warp tests face l against the warp's rectangle (edge_fails: the
//     corner maximum of each edge function, with a rounding margin derived
//     there), and one ballot gives the faces that can touch the warp; the
//     warp evaluates only those, in a warp-uniform loop.  A face binned to
//     a tile typically reaches one or two of its eight warps; sentinel
//     slots never reach any.  Rejection skips only pairs whose pixels all
//     fail the inside test, so no key changes.
//   * Whole chunks by cp.async.bulk.  A chunk is contiguous (CF x G x 3
//     floats); one producer lane copies it into a ring of 2-4 slots with an
//     mbarrier pair each, so chunk i + 1.. land while chunk i is evaluated.
//   * Heavy tiles split across a thread-block cluster.  The blocks of a
//     cluster share a tile; block r walks the tile's chunks r, r + k, ...
//     (k blocks a cluster), keeping per pixel its minimum key and owner.
//     Then every block publishes its keys in shared memory, and after a
//     cluster barrier each block reads the others' (distributed shared
//     memory): the block whose key is the minimum writes the pixel, its
//     key and its attributes (block 0 writes pixels that no face covers).
//     A key names its face, which occurs once in a tile's list, so exactly
//     one block holds the minimum, and the minimum does not depend on the
//     order of the walk: the same bits as one block walking every chunk.
//   * The epilogue evaluates the winner's attribute planes once a pixel,
//     from the chunk in the ring where it still is (always, when a block
//     walks at most as many chunks as the ring has slots), or else from
//     the table in device memory.
// An empty tile (85% of the video's base pass) takes a short path: its
// block 0 writes INT32_MAX and zeros, and every block of its cluster
// leaves without setting up the ring or waiting at a cluster barrier.
//
// The wrapper allocates the outputs; the kernel runs on the caller's
// stream, allocates nothing, synchronises nothing, and the entry point
// returns the launch's error.
#include "raster_common.cuh"

namespace {

using namespace raster;
namespace cg = cooperative_groups;

constexpr int kHead = 15;                 // e0, e1, e2, zq, fid x (a, b, c)

__global__ void __launch_bounds__(kThreads)
fused_raster_kernel(const float* __restrict__ table,  // (B, MAXC, CF, G, 3)
                    const int* __restrict__ starts,   // (B, T + 1)
                    int* __restrict__ win,            // (B, H, W)
                    float* __restrict__ attr,         // (B, C, H, W)
                    int H, int W, int MAXC, int CF, int C, int fb,
                    float zcap, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int TX = W / kTileW;
  const int T = TX * (H / kTileH);
  const int t = blockIdx.x / ranks;
  const int b = blockIdx.y;
  const int c_begin = starts[(size_t)b * (T + 1) + t];
  const int c_end = starts[(size_t)b * (T + 1) + t + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lx = 32 * (warp & 3) + lane;
  const int ly = 4 * (warp >> 2);
  const int x = (t % TX) * kTileW + lx;
  const int y0 = (t / TX) * kTileH + ly;
  const size_t plane = (size_t)H * W;
  if (c_end <= c_begin) {
    // An empty tile (most of them): block 0 writes INT32_MAX and zeros,
    // every block of the cluster leaves at once (no barrier is waited for).
    if (rank == 0 && warp < kConsumers / 32)
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const size_t pix = (size_t)(y0 + k) * W + x;
        win[(size_t)b * plane + pix] = INT_MAX;
        for (int ch = 0; ch < C; ++ch)
          attr[((size_t)b * C + ch) * plane + pix] = 0.0f;
      }
    return;
  }
  const int n = rank_chunks(c_begin, c_end, rank, ranks);
  const int row = 3 * (5 + C);                        // floats per face
  const int chunk = CF * row;                         // floats per chunk
  const float* tab = table + (size_t)b * MAXC * chunk;
  auto chunk_at = [&](int i) {                        // i-th of this block
    return tab + (size_t)(c_begin + rank + i * ranks) * chunk;
  };
  Ring ring;
  ring.base = smem_u32(smem);
  ring.stages = stages;
  ring.bytes = chunk * 4;
  ring.bars = ring.base + ring_bytes(ring.bytes, stages);
  int* keys = reinterpret_cast<int*>(smem + ring_bytes(ring.bytes, stages) +
                                     kBarBytes);
  const float* slots = reinterpret_cast<const float*>(smem);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const float px = (float)lx + 0.5f;
  int best[kPix];
  int owner[kPix];                                    // i * CF + face
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    best[k] = INT_MAX;
    owner[k] = -1;
  }

  if (warp == kConsumers / 32) {
    // ================= producer: one lane copies this block's chunks
    if (lane == 0)
      for (int i = 0; i < n; ++i) ring.put(i, chunk_at(i));
  } else {
    // ================= consumers
    const WarpRect rect = warp_rect(warp);
    for (int i = 0; i < n; ++i) {
      ring.take(i);
      const float* q0 = slots + (i % stages) * chunk;
      for (int g0 = 0; g0 < CF; g0 += 32) {
        const int fl = g0 + lane;
        bool keep = false;
        if (fl < CF) {
          const float* q = q0 + fl * row;
          keep = !(edge_fails(q[0], q[1], q[2], rect) ||
                   edge_fails(q[3], q[4], q[5], rect) ||
                   edge_fails(q[6], q[7], q[8], rect));
        }
        unsigned live = __ballot_sync(0xffffffffu, keep);
        while (live) {
          const int f = g0 + __ffs(live) - 1;
          live &= live - 1;
          const float* q = q0 + f * row;
          const float a0x = __fmul_rn(q[0], px);
          const float a1x = __fmul_rn(q[3], px);
          const float a2x = __fmul_rn(q[6], px);
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const float py = (float)(ly + k) + 0.5f;
            const float e0 = affine(a0x, q[1], q[2], py);
            const float e1 = affine(a1x, q[4], q[5], py);
            const float e2 = affine(a2x, q[7], q[8], py);
            if (e0 >= kNegEps && e1 >= kNegEps && e2 >= kNegEps) {
              const float zq = affine(__fmul_rn(q[9], px), q[10], q[11], py);
              const int dq = (int)fminf(fmaxf(zq, 0.0f), zcap);
              const int key =
                  (int)(((unsigned)dq << fb) | (unsigned)(int)q[14]);
              if (key < best[k]) {
                best[k] = key;
                owner[k] = i * CF + f;
              }
            }
          }
        }
      }
      ring.release(i, lane);
    }
  }

  // ---- the combine: the cluster's minimum key per pixel, and its owner
  const bool consumer = warp < kConsumers / 32;
  if (ranks > 1) {
    if (consumer)
#pragma unroll
      for (int k = 0; k < kPix; ++k) keys[(ly + k) * kTileW + lx] = best[k];
    cluster.sync();
  }
  if (consumer) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      int key = best[k];
      for (int r = 0; r < ranks; ++r)
        if (r != rank)
          key = min(key, cluster.map_shared_rank(keys, r)[(ly + k) * kTileW +
                                                          lx]);
      const bool covered = key != INT_MAX;
      if (covered ? best[k] != key : rank != 0) continue;
      const size_t pix = (size_t)(y0 + k) * W + x;
      win[(size_t)b * plane + pix] = key;
      float* out = attr + (size_t)b * C * plane + pix;
      if (covered) {
        const int i = owner[k] / CF, f = owner[k] - i * CF;
        const float* p =
            (i >= n - stages ? slots + (i % stages) * chunk : chunk_at(i)) +
            f * row + kHead;
        const float py = (float)(ly + k) + 0.5f;
        for (int ch = 0; ch < C; ++ch)
          out[(size_t)ch * plane] =
              affine(__fmul_rn(p[3 * ch], px), p[3 * ch + 1], p[3 * ch + 2],
                     py);
      } else {
        for (int ch = 0; ch < C; ++ch) out[(size_t)ch * plane] = 0.0f;
      }
    }
  }
  if (ranks > 1) cluster.sync();        // no block leaves while read
}

}  // namespace

// Launches the kernel on `stream` over grid (tiles x cluster, frames), in
// clusters of `cluster` blocks (1 or 2), and returns the launch's
// error.  H must be a multiple of 8 and W of 128, the table 16-byte
// aligned (the wrapper checks); zcap = float(depth_levels - 1).
extern "C" int tpubody_fused_raster(const float* table, const int* starts,
                                    int* win, float* attr, int B, int H,
                                    int W, int MAXC, int CF, int C, int fb,
                                    float zcap, int cluster,
                                    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (cluster != 1 && cluster != 2)
    return (int)cudaErrorInvalidValue;
  const int T = (W / kTileW) * (H / kTileH);
  const int chunk_bytes = CF * 3 * (5 + C) * 4;
  const int stages = ring_stages(chunk_bytes);
  return launch_clustered(fused_raster_kernel, T, B, cluster,
                          smem_bytes(chunk_bytes, stages), stream, table,
                          starts, win, attr, H, W, MAXC, CF, C, fb, zcap,
                          stages);
}
