// fused_raster: tiled triangle rasterization fused with attribute
// interpolation, one thread block per (frame, 8x128-pixel tile), for
// Hopper (sm_90a).
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
// fp32): per face and pixel it evaluates three edge functions (3 x (1 mul
// + 2 add), the a * px products shared by a thread's four pixels) and
// three comparisons, about 13 operations; a chunk of 32 faces is 3 KB of
// table.  For a chunk that is 32 x 1024 x 13 = 0.43 MFLOP against 3 KB,
// so the kernel is bound by operations, not bytes; the output planes
// ((1 + C) x 4 bytes per pixel) are the larger share of its bytes.
//
// What the design does about it: 256 threads per tile, four pixels each;
// consecutive threads are consecutive in x, so every store of win and of
// an attribute plane is a coalesced 512-byte row segment.  Per chunk the
// block copies the 15 edge/depth/fid coefficients of each face into shared
// memory and every thread walks the faces reading them as broadcasts; it
// keeps the running minimum key and its owner (chunk, lane) in registers.
// Depth and key are computed only for covered pixels.  The winner's
// attribute planes are evaluated ONCE, after the loop, from the owner's
// coefficients in global memory (3 * C contiguous floats): evaluating on
// every improvement of the key would also be right, but costs C planes per
// improvement instead of per pixel, and attribute work would scale with
// depth complexity.  An empty tile writes INT32_MAX and zeros and leaves.
// Double-buffered copies (cp.async / TMA), several tiles per block and
// balancing full against empty tiles are left for later.
//
// The wrapper allocates the outputs; the kernel runs on the caller's
// stream, allocates nothing, synchronises nothing, and the entry point
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = 256;             // 2 rows of 128 pixels
constexpr int kPix = kTileH / 2;          // pixels per thread: rows r, r+2, ..
constexpr int kHead = 15;                 // e0, e1, e2, zq, fid x (a, b, c)
constexpr float kNegEps = -1e-7f;

__device__ __forceinline__ float affine(float ax, float b, float c, float py) {
  // (a * px + b * py) + c with ax = a * px already rounded.
  return __fadd_rn(__fadd_rn(ax, __fmul_rn(b, py)), c);
}

__global__ void __launch_bounds__(kThreads)
fused_raster_kernel(const float* __restrict__ table,  // (B, MAXC, CF, G, 3)
                    const int* __restrict__ starts,   // (B, T + 1)
                    int* __restrict__ win,            // (B, H, W)
                    float* __restrict__ attr,         // (B, C, H, W)
                    int H, int W, int MAXC, int CF, int C, int fb,
                    float zcap) {
  extern __shared__ float coef[];                     // CF * kHead
  const int TX = W / kTileW;
  const int T = TX * (H / kTileH);
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int c_begin = starts[(size_t)b * (T + 1) + t];
  const int c_end = starts[(size_t)b * (T + 1) + t + 1];
  const int row = 3 * (5 + C);                        // floats per face
  const float* tab = table + (size_t)b * MAXC * CF * row;

  const int lx = threadIdx.x & (kTileW - 1);
  const int ly = threadIdx.x >> 7;                    // 0 or 1
  const float px = (float)lx + 0.5f;
  float py[kPix];
  int best[kPix];
  int owner[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    py[k] = (float)(ly + 2 * k) + 0.5f;
    best[k] = INT_MAX;
    owner[k] = -1;
  }

  for (int c = c_begin; c < c_end; ++c) {
    __syncthreads();                 // the previous chunk has been read
    const float* src = tab + (size_t)c * CF * row;
    for (int i = threadIdx.x; i < CF * kHead; i += kThreads) {
      const int f = i / kHead;
      coef[i] = src[f * row + (i - f * kHead)];
    }
    __syncthreads();
    for (int f = 0; f < CF; ++f) {
      const float* q = coef + f * kHead;
      const float a0x = __fmul_rn(q[0], px);
      const float a1x = __fmul_rn(q[3], px);
      const float a2x = __fmul_rn(q[6], px);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float e0 = affine(a0x, q[1], q[2], py[k]);
        const float e1 = affine(a1x, q[4], q[5], py[k]);
        const float e2 = affine(a2x, q[7], q[8], py[k]);
        if (e0 >= kNegEps && e1 >= kNegEps && e2 >= kNegEps) {
          const float zq = affine(__fmul_rn(q[9], px), q[10], q[11], py[k]);
          const int dq = (int)fminf(fmaxf(zq, 0.0f), zcap);
          const int key =
              (int)(((unsigned)dq << fb) | (unsigned)(int)q[14]);
          if (key < best[k]) {
            best[k] = key;
            owner[k] = c * CF + f;
          }
        }
      }
    }
  }

  const int x = (t % TX) * kTileW + lx;
  const int y0 = (t / TX) * kTileH + ly;
  const size_t plane = (size_t)H * W;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const size_t pix = (size_t)(y0 + 2 * k) * W + x;
    win[(size_t)b * plane + pix] = best[k];
    float* out = attr + (size_t)b * C * plane + pix;
    if (owner[k] >= 0) {
      const float* p = tab + (size_t)owner[k] * row + kHead;
      for (int ch = 0; ch < C; ++ch)
        out[(size_t)ch * plane] =
            affine(__fmul_rn(p[3 * ch], px), p[3 * ch + 1], p[3 * ch + 2],
                   py[k]);
    } else {
      for (int ch = 0; ch < C; ++ch) out[(size_t)ch * plane] = 0.0f;
    }
  }
}

}  // namespace

// Launches the kernel on `stream` over grid (tiles, frames) and returns
// cudaGetLastError().  H must be a multiple of 8 and W of 128 (the wrapper
// checks); zcap = float(depth_levels - 1).
extern "C" int tpubody_fused_raster(const float* table, const int* starts,
                                    int* win, float* attr, int B, int H,
                                    int W, int MAXC, int CF, int C, int fb,
                                    float zcap, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int T = (W / kTileW) * (H / kTileH);
  const dim3 grid(T, B);
  const size_t smem = (size_t)CF * kHead * sizeof(float);
  fused_raster_kernel<<<grid, kThreads, smem, stream>>>(
      table, starts, win, attr, H, W, MAXC, CF, C, fb, zcap);
  return (int)cudaGetLastError();
}
