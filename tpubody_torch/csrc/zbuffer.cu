// zbuffer: tiled z-buffer rasterization (coverage + packed depth/face key,
// no attributes), one thread block per (frame, 8x128-pixel tile), for
// Hopper (sm_90a).
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
// fp32): per face and pixel three edge functions (one multiply and two
// adds each, the a * px products shared by a thread's four pixels) and
// three comparisons, about 13 operations; a chunk is 10 KB of table for
// 128 x 1024 x 13 = 1.7 MFLOP, so a tile with faces is bound by
// operations.  A frame of mostly empty tiles is bound by the 4 bytes a
// pixel it writes.
//
// What the design does about it: 256 threads a tile, four pixels each,
// consecutive threads consecutive in x, so each store of zbuf is a
// coalesced 512-byte row segment.  Per chunk the block copies the 640
// float4 rows into shared memory (coalesced 16-byte loads) and every
// thread walks the 128 faces reading them as broadcasts; the running
// minimum stays in registers.  Depth and key are computed only for covered
// pixels.  A chunk whose faces are all sentinels costs the same as a full
// one; skipping a chunk's sentinel tail, cp.async double buffering and
// balancing full against empty tiles are left for later.
//
// The wrapper allocates the output; the kernel runs on the caller's
// stream, allocates nothing, synchronises nothing, and the entry point
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = 256;             // 2 rows of 128 pixels
constexpr int kPix = kTileH / 2;          // pixels per thread: rows r, r+2, ..
constexpr int kCF = 128;                  // faces per chunk
constexpr int kRows = 5 * kCF;            // float4 rows per chunk
constexpr float kNegEps = -1e-7f;

__device__ __forceinline__ float affine(float ax, float b, float c, float py) {
  // (a * px + b * py) + c with ax = a * px already rounded.
  return __fadd_rn(__fadd_rn(ax, __fmul_rn(b, py)), c);
}

__global__ void __launch_bounds__(kThreads)
zbuffer_kernel(const float4* __restrict__ table,   // (B, T, NC, 640)
               const int* __restrict__ nchunks,    // (B, T)
               int* __restrict__ zbuf,             // (B, H, W)
               int H, int W, int NC, int fb, float zcap) {
  __shared__ float4 coef[kRows];                   // 10 KB
  const int TX = W / kTileW;
  const int T = TX * (H / kTileH);
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const size_t cell = (size_t)b * T + t;
  const int n = min(max(nchunks[cell], 0), NC);
  const float4* tab = table + cell * NC * kRows;

  const int lx = threadIdx.x & (kTileW - 1);
  const int ly = threadIdx.x >> 7;                 // 0 or 1
  const float px = (float)lx + 0.5f;
  float py[kPix];
  int best[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    py[k] = (float)(ly + 2 * k) + 0.5f;
    best[k] = INT_MAX;
  }

  for (int c = 0; c < n; ++c) {
    __syncthreads();                 // the previous chunk has been read
    const float4* src = tab + (size_t)c * kRows;
    for (int i = threadIdx.x; i < kRows; i += kThreads) coef[i] = src[i];
    __syncthreads();
    for (int f = 0; f < kCF; ++f) {
      const float4 q0 = coef[f];
      const float4 q1 = coef[kCF + f];
      const float4 q2 = coef[2 * kCF + f];
      const float a0x = __fmul_rn(q0.x, px);
      const float a1x = __fmul_rn(q1.x, px);
      const float a2x = __fmul_rn(q2.x, px);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float e0 = affine(a0x, q0.y, q0.z, py[k]);
        const float e1 = affine(a1x, q1.y, q1.z, py[k]);
        const float e2 = affine(a2x, q2.y, q2.z, py[k]);
        if (e0 >= kNegEps && e1 >= kNegEps && e2 >= kNegEps) {
          const float4 qz = coef[3 * kCF + f];
          const float zq = affine(__fmul_rn(qz.x, px), qz.y, qz.z, py[k]);
          const int dq = (int)fminf(fmaxf(zq, 0.0f), zcap);
          const int key = (int)(((unsigned)dq << fb) |
                                (unsigned)(int)coef[4 * kCF + f].z);
          best[k] = min(best[k], key);
        }
      }
    }
  }

  const int x = (t % TX) * kTileW + lx;
  const int y0 = (t / TX) * kTileH + ly;
  int* out = zbuf + (size_t)b * H * W;
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    out[(size_t)(y0 + 2 * k) * W + x] = best[k];
}

}  // namespace

// Launches the kernel on `stream` over grid (tiles, frames) and returns
// cudaGetLastError().  H must be a multiple of 8 and W of 128, and the
// table 16-byte aligned (the wrapper checks); zcap = float(depth_levels - 1).
extern "C" int tpubody_zbuffer(const float* table, const int* nchunks,
                               int* zbuf, int B, int H, int W, int NC, int fb,
                               float zcap, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int T = (W / kTileW) * (H / kTileH);
  const dim3 grid(T, B);
  zbuffer_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(table), nchunks, zbuf, H, W, NC, fb,
      zcap);
  return (int)cudaGetLastError();
}
