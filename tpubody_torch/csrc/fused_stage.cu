// fused_stage: one stride-1 ResNet bottleneck (1x1 -> 3x3 -> 1x1, BatchNorm
// folded, residual add, relus) in one kernel, one thread block per 8x16
// pixel tile of one image, on the tensor cores, for Hopper (sm_90a).  A
// chain of bottlenecks is one launch a block; between blocks the bf16
// activation goes through device memory, which changes no bit, because a
// block's output is rounded to bf16 anyway.
//
// Replaces: tpubody/models/pallas_resnet.py::_stage_kernel (the Pallas TPU
// kernel behind run_stage).  It computes the same function; the TPU's shape
// is not carried over: no channel-major (C, P) layout, no zero ring around
// the image, no lane padding to 128, no nine circular rolls of a whole
// image, no mask operand, no packed-int32 roll and so no even-C_mid rule.
// There a whole 56^2 image sits in fast memory and a 3x3 tap is a lane
// shift; a Hopper block has 227 KB, so here the unit is a spatial tile in
// NHWC (channels innermost), conv1 is recomputed on the tile's one-pixel
// halo, and a 3x3 tap is a shifted row offset into the halo tile of h1 in
// shared memory.
//
// Inputs (tpubody_torch/models/fused_resnet.py packs the weights once, at
// fuse_stage time; Xp = X rounded up to a multiple of 16, zero filled):
//   x  (B, H, W, Cin) bf16, NHWC, contiguous, 16-byte aligned
//   w1 (Cmid_p, Cin_p) bf16, b1 (Cmid_p) f32
//   w2 (9, Cmid_p, Cmid_p) bf16: tap-major, tap = dy * 3 + dx, then output
//      channel, then input channel; b2 (Cmid_p) f32
//   w3 (Cout_p, Cmid_p) bf16, b3 (Cout_p) f32
//   wd (Cout_p, Cin_p) bf16 and bd (Cout_p) f32, or null for an identity
//      residual (then Cin == Cout)
// Output: y (B, H, W, Cout) bf16.
// The activations are never padded: the loaders zero-fill channels past
// Cin and pixels outside the image, the stores mask the ragged right and
// bottom tiles and channels past Cout.
//
// Arithmetic, which decides the bits: operands bf16, every product summed
// in f32 (mma.sync m16n8k16, bf16 in, f32 out), bias added in f32, relu,
// h1, h2 and y rounded to bf16 to nearest even.  h1 at halo pixels outside
// the image is written as ZERO: conv2's padding pads h1, and h1 of a zero
// input would be relu(b1), not 0.  The residual of a widening block is
// wd . x + bd in f32, unrounded, accumulated with w3 . h2; the residual of
// an identity block is the bf16 x widened.  The order of the f32 sums
// differs from the plain PyTorch version's, so the two differ where a sum
// lands within an f32 rounding of a bf16 boundary: a tolerance, not
// equality.
//
// What bounds it on an H100 SXM (data sheet: 989 TFLOP/s dense bf16,
// 3.35 TB/s): a bottleneck at 64 -> 256 channels does 139,264 to 147,456
// operations a pixel for 640 bytes read and written, about 220 operations
// a byte, and at 512 -> 128 -> 512 channels 557,056 for 2,048 bytes (272
// a byte): both sit near the ridge (295), bound by operations once the
// halo's recomputation (180 pixels of conv1 for 128 of output) is added.
//
// What the design does about it: h1 (180 halo pixels) and h2 (128 pixels)
// never leave shared memory.  Each of the three products (and the
// downsample) is a loop over K slices through a ring of buffers in shared
// memory: cp.async brings the next slice of the weights (and, for conv1
// and the downsample, of x, zero-filled outside the image) while the 8
// warps (2 along pixels x 4 along channels) multiply the current one with
// mma.sync on ldmatrix fragments, one barrier a slice; row strides of
// K + 8 keep ldmatrix free of bank conflicts.  conv1 runs in two passes of
// 96 halo rows so that its accumulators fit.  Output channels go in chunks
// of 128, split over the four warps along channels in widths of 16 or 32,
// so that no warp idles at C_mid = 64.  The last epilogue goes through
// shared memory (over h1 and the ring, both dead by then): the residual
// tile comes in and y goes out in 16-byte pieces.  Two blocks on an SM
// matter more than anything else measured (a build that fits only one is
// a fifth to nearly a half slower), so registers are capped at 128, the x ring shares its
// room with h2 where there is no downsample, and of the two builds (K
// slices of 64 or 32, ring of 2) the first that leaves room for a second
// block is taken: 92 KB a block at 256 -> 64 -> 256, 87 KB with the
// downsample (slices of 32), 107 KB at 512 -> 128 -> 512 (slices of 32).  Left for later: wgmma on shared
// memory descriptors (fragment traffic through ldmatrix is what the tensor
// cores wait for now), weights shared by more than 128 pixels (they are
// re-read from L2 for every tile: 170 KB a tile at stage 1, 690 KB at
// stage 2), TMA, and a chain in one launch.  Tried and dropped: computing
// only the rows of a bottom tile that lie in the image (4 of 8 at 28^2)
// gained nothing at stage 2 and cost 7% at stage 1.
//
// The wrapper allocates the output; the kernel runs on the caller's
// stream, allocates nothing, synchronises nothing, and the entry point
// returns cudaGetLastError().
//
// Timing builds: ablate_fused_stage.py compiles this file with one
// ABLATE_* macro defined each, which takes a part out (the tensor-core
// products, the fragment loads, the loads of x or of the weights, the last
// epilogue, one of the convolutions) or forces one (K slice, ring) build
// with -DABLATE_KS=.. -DABLATE_S=...  Such a build computes wrong values by
// design and only its time is read.  With no macro defined, the #if lines
// below change nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTH = 8;                        // output tile, rows
constexpr int kTW = 16;                       // output tile, columns
constexpr int kTilePix = kTH * kTW;           // 128
constexpr int kHW = kTW + 2;                  // halo tile width
constexpr int kHaloPix = (kTH + 2) * kHW;     // 180
constexpr int kHaloRows = 192;                // 180 rounded up to 12 x 16
constexpr int kPassRows = kHaloRows / 2;      // conv1 runs in two passes
constexpr int kThreads = 256;
constexpr int kNC = 128;                      // output channels per chunk
constexpr int kMaxSmem = 232448;              // 227 KB a block
// Two blocks fit an SM if each takes at most this (228 KB an SM, 1 KB of
// it reserved for each block).
constexpr int kHalfSmem = (233472 - 2 * 1024) / 2;

__host__ __device__ inline int round16(int c) { return (c + 15) & ~15; }

// bf16 elements of shared memory for one block, with K slices `ks` wide
// in a ring of `stages` buffers.
__host__ __device__ inline int smem_elems(int cmid_p, bool down, int ks,
                                          int stages) {
  const int ldh = cmid_p + 8;
  const int ld = ks + 8;
  const int h2 = kTilePix * ldh;
  const int a = stages * (down ? kTilePix : kPassRows) * ld;
  const int tail = down ? h2 + a : (h2 > a ? h2 : a);
  return kHaloRows * ldh + stages * kNC * ld + tail;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without passing through registers; zeros
// where `pred` is false (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#ifdef ABLATE_MMA
  return;
#endif
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += act . wt^T over `ksteps` steps of 16 along K.  A warp owns MT
// row tiles of 16 and up to two pairs of column tiles of 8 (`npairs`).
// a_addr[i]: shared address of the row this lane names to ldmatrix for
// row tile i (row l & 15, column (l >> 4) * 8) at the slice's first
// column; b_addr: the same for the weights (row (l & 7) + (l >> 4) * 8 of
// the warp's first pair, column ((l >> 3) & 1) * 8).
template <int MT>
__device__ __forceinline__ void mma_slice(float (&acc)[MT][4][4],
                                          const uint32_t (&a_addr)[MT],
                                          uint32_t b_addr, int ld,
                                          int npairs, int ksteps) {
#ifdef ABLATE_FRAGMENTS
  return;
#endif
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t b[2][4];
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      b[jp][0] = b[jp][1] = b[jp][2] = b[jp][3] = 0u;
      if (jp < npairs)
        ldmatrix_x4(b[jp], b_addr + (jp * 16 * ld + kk * 16) * 2);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr[i] + kk * 32);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        if (jp < npairs) {
          mma_bf16(acc[i][2 * jp], a, b[jp][0], b[jp][1]);
          mma_bf16(acc[i][2 * jp + 1], a, b[jp][2], b[jp][3]);
        }
      }
    }
  }
}

// dst rows [0, nrows) (stride ld) <- channels [k0, k0 + ks) of the pixels
// row_base .. of a grid `gw` wide whose origin is image pixel (oy, ox);
// zero for pixels past `npix` or outside the image and for channels past
// Cin.  Asynchronous (cp.async) where Cin is a multiple of 8.
__device__ __forceinline__ void load_act(bf16* __restrict__ dst, int ld,
                                         const bf16* __restrict__ xb, int H,
                                         int W, int Cin, int row_base,
                                         int nrows, int npix, int gw, int oy,
                                         int ox, int k0, int ks) {
#ifdef ABLATE_X_LOADS
  return;
#endif
  const int upr = ks >> 3;                    // 16-byte units a row
  const bool vec = (Cin & 7) == 0;
  for (int u = threadIdx.x; u < nrows * upr; u += kThreads) {
    const int row = u / upr;
    const int c8 = (u - row * upr) << 3;
    const int lp = row_base + row;
    const int py = oy + lp / gw;
    const int px = ox + lp % gw;
    const int k = k0 + c8;
    const bool in = lp < npix && py >= 0 && py < H && px >= 0 && px < W &&
                    k < Cin;
    const bf16* src = in ? xb + ((size_t)py * W + px) * Cin + k : xb;
    bf16* d = dst + row * ld + c8;
    if (vec) {
      cp_async16(d, src, in);
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
      unsigned short e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = in && k + i < Cin ? s[i] : 0;
      *reinterpret_cast<uint4*>(d) =
          make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                     e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
    }
  }
}

// dst rows [0, nrows) (stride ld) <- w[row][0, ks), row stride ldw.
__device__ __forceinline__ void load_w(bf16* __restrict__ dst, int ld,
                                       const bf16* __restrict__ w, int ldw,
                                       int nrows, int ks) {
#ifdef ABLATE_W_LOADS
  return;
#endif
  const int upr = ks >> 3;
  for (int u = threadIdx.x; u < nrows * upr; u += kThreads) {
    const int row = u / upr;
    const int c8 = (u - row * upr) << 3;
    cp_async16(dst + row * ld + c8, w + (size_t)row * ldw + c8, true);
  }
}

// R rounds of (load a slice, multiply it) through a ring of S buffers:
// rounds r + 1 .. r + S - 1 are in flight while round r is multiplied, and
// a round costs one barrier.  fetch(r, buf) starts the loads of round r
// into buffer buf; compute(r, buf) consumes them.  The barrier of round r
// also says that every warp has finished round r - 1, whose buffer is the
// one refilled next.
template <int S, class Fetch, class Compute>
__device__ __forceinline__ void pipeline(int R, Fetch fetch, Compute compute) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < R) fetch(s, s);
    cp_async_commit();
  }
  for (int r = 0; r < R; ++r) {
    cp_async_wait<S - 2>();        // round r has landed
    __syncthreads();
    const int nxt = r + S - 1;
    if (nxt < R) fetch(nxt, nxt % S);
    cp_async_commit();
    compute(r, r % S);
  }
  __syncthreads();                 // the ring may be refilled
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

template <int kKS, int kS>
__global__ void __launch_bounds__(kThreads, 2)
bottleneck_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                  const bf16* __restrict__ w1, const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ b2,
                  const bf16* __restrict__ w3, const float* __restrict__ b3,
                  const bf16* __restrict__ wd, const float* __restrict__ bd,
                  int H, int W, int Cin, int Cmid_p, int Cout, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Cin_p = round16(Cin);
  const int Cout_p = round16(Cout);
  const int ldh = Cmid_p + 8;
  const bool down = wd != nullptr;
  constexpr int kLD = kKS + 8;               // row stride of a slice buffer
  constexpr int kWBuf = kNC * kLD;           // one weight slice buffer
  bf16* sH1 = reinterpret_cast<bf16*>(smem_raw);   // [192][ldh]
  bf16* sW = sH1 + kHaloRows * ldh;                // kS x [128][kLD]
  bf16* sH2 = sW + kS * kWBuf;                     // [128][ldh]
  bf16* sA = down ? sH2 + kTilePix * ldh : sH2;    // kS x [128 or 96][kLD]
  const int abuf = (down ? kTilePix : kPassRows) * kLD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;                   // row of the fragment
  const int t = lane & 3;                    // column pair of the fragment
  const int wm = warp >> 2;                  // 0..1 along pixels
  const int wn = warp & 3;                   // 0..3 along channels
  const int lrow = lane & 15;                // ldmatrix: row this lane names
  const int lcol = (lane >> 4) * 8;          //           and its column
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const size_t img = (size_t)blockIdx.y * H * W;
  const bf16* xb = x + img * Cin;
  const int nk_in = (Cin_p + kKS - 1) / kKS;
  const int nk_mid = (Cmid_p + kKS - 1) / kKS;
  const uint32_t sW_u = smem_u32(sW), sA_u = smem_u32(sA);
  const uint32_t sH1_u = smem_u32(sH1), sH2_u = smem_u32(sH2);

  // A chunk of up to 128 output channels is split over the four warps
  // along channels in widths of 16 (chunk <= 64) or 32: -> first column,
  // number of column-tile pairs, and the lane's ldmatrix offset (bytes)
  // into a weight slice buffer.
  int wcol0, npairs;
  uint32_t wofs;
  auto split = [&](int chunk) {
    const int wcols = chunk <= 64 ? 16 : 32;
    wcol0 = wn * wcols;
    npairs = max(0, min(wcols, chunk - wcol0)) >> 4;
    wofs = ((wcol0 + (lane & 7) + (lane >> 4) * 8) * kLD +
            ((lane >> 3) & 1) * 8) * 2;
  };

#ifndef ABLATE_CONV1
  // ---- conv1 on the halo tile: h1 = bf16(relu(w1 . x + b1)), 0 outside
  for (int n0 = 0; n0 < Cmid_p; n0 += kNC) {
    const int nrows = min(kNC, Cmid_p - n0);
    split(nrows);
    for (int pass = 0; pass < 2; ++pass) {
      float acc[3][4][4];
      zero<3>(acc);
      pipeline<kS>(
          nk_in,
          [&](int r, int buf) {
            const int k0 = r * kKS;
            const int ks = min(kKS, Cin_p - k0);
            load_act(sA + buf * abuf, kLD, xb, H, W, Cin, pass * kPassRows,
                     kPassRows, kHaloPix, kHW, y0 - 1, x0 - 1, k0, ks);
            load_w(sW + buf * kWBuf, kLD, w1 + (size_t)n0 * Cin_p + k0, Cin_p,
                   nrows, ks);
          },
          [&](int r, int buf) {
            uint32_t a_addr[3];
#pragma unroll
            for (int i = 0; i < 3; ++i)
              a_addr[i] = sA_u + (buf * abuf +
                                  ((wm * 3 + i) * 16 + lrow) * kLD + lcol) * 2;
            mma_slice<3>(acc, a_addr, sW_u + buf * kWBuf * 2 + wofs, kLD,
                         npairs, min(kKS, Cin_p - r * kKS) >> 4);
          });
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int hp = pass * kPassRows + (wm * 3 + i) * 16 + g + half * 8;
          const int py = y0 - 1 + hp / kHW;
          const int px = x0 - 1 + hp % kHW;
          const bool inside = hp < kHaloPix && py >= 0 && py < H && px >= 0 &&
                              px < W;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < 2 * npairs) {
              const int n = n0 + wcol0 + j * 8 + t * 2;
              float v0 = 0.0f, v1 = 0.0f;
              if (inside) {
                v0 = fmaxf(acc[i][j][half * 2] + b1[n], 0.0f);
                v1 = fmaxf(acc[i][j][half * 2 + 1] + b1[n + 1], 0.0f);
              }
              *reinterpret_cast<__nv_bfloat162*>(sH1 + hp * ldh + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }
    }
  }

#endif
#ifndef ABLATE_CONV2
  // ---- conv2, 3x3 over h1 in shared memory: h2 = bf16(relu(. + b2))
  for (int n0 = 0; n0 < Cmid_p; n0 += kNC) {
    const int nrows = min(kNC, Cmid_p - n0);
    split(nrows);
    float acc[4][4][4];
    zero<4>(acc);
    pipeline<kS>(
        9 * nk_mid,
        [&](int r, int buf) {
          const int tap = r / nk_mid;
          const int k0 = (r - tap * nk_mid) * kKS;
          load_w(sW + buf * kWBuf, kLD,
                 w2 + ((size_t)tap * Cmid_p + n0) * Cmid_p + k0, Cmid_p, nrows,
                 min(kKS, Cmid_p - k0));
        },
        [&](int r, int buf) {     // the first round's barrier completes h1
          const int tap = r / nk_mid;
          const int k0 = (r - tap * nk_mid) * kKS;
          const int dy = tap / 3;
          const int dx = tap - dy * 3;
          uint32_t a_addr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a_addr[i] = sH1_u + (((wm * 4 + i + dy) * kHW + dx + lrow) * ldh +
                                 k0 + lcol) * 2;
          mma_slice<4>(acc, a_addr, sW_u + buf * kWBuf * 2 + wofs, kLD,
                       npairs, min(kKS, Cmid_p - k0) >> 4);
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (wm * 4 + i) * 16 + g + half * 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < 2 * npairs) {
            const int n = n0 + wcol0 + j * 8 + t * 2;
            const float v0 = fmaxf(acc[i][j][half * 2] + b2[n], 0.0f);
            const float v1 = fmaxf(acc[i][j][half * 2 + 1] + b2[n + 1], 0.0f);
            *reinterpret_cast<__nv_bfloat162*>(sH2 + p * ldh + n) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }

#endif
#ifndef ABLATE_CONV3
  // ---- conv3 (+ downsample) + residual: y = bf16(relu(. + b3 + res))
  for (int n0 = 0; n0 < Cout_p; n0 += kNC) {
    const int nrows = min(kNC, Cout_p - n0);
    split(nrows);
    float acc[4][4][4];
    zero<4>(acc);
    pipeline<kS>(
        nk_mid + (down ? nk_in : 0),
        [&](int r, int buf) {
          if (r < nk_mid) {
            const int k0 = r * kKS;
            load_w(sW + buf * kWBuf, kLD, w3 + (size_t)n0 * Cmid_p + k0, Cmid_p,
                   nrows, min(kKS, Cmid_p - k0));
          } else {
            const int k0 = (r - nk_mid) * kKS;
            const int ks = min(kKS, Cin_p - k0);
            load_act(sA + buf * abuf, kLD, xb, H, W, Cin, 0, kTilePix, kTilePix,
                     kTW, y0, x0, k0, ks);
            load_w(sW + buf * kWBuf, kLD, wd + (size_t)n0 * Cin_p + k0, Cin_p,
                   nrows, ks);
          }
        },
        [&](int r, int buf) {     // the first round's barrier completes h2
          uint32_t a_addr[4];
          int ks;
          if (r < nk_mid) {
            const int k0 = r * kKS;
            ks = min(kKS, Cmid_p - k0);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a_addr[i] = sH2_u + (((wm * 4 + i) * 16 + lrow) * ldh + k0 +
                                   lcol) * 2;
          } else {
            ks = min(kKS, Cin_p - (r - nk_mid) * kKS);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a_addr[i] = sA_u + (buf * abuf +
                                  ((wm * 4 + i) * 16 + lrow) * kLD + lcol) * 2;
          }
          mma_slice<4>(acc, a_addr, sW_u + buf * kWBuf * 2 + wofs, kLD,
                       npairs, ks >> 4);
        });
    // The epilogue goes through shared memory (h1 and the weight ring are
    // dead here), so that the residual is read and y is written in
    // 16-byte pieces, a pixel's channels side by side: the residual tile
    // comes in, every thread adds its accumulators in f32 and rounds in
    // place, the tile goes out.
    bf16* sOut = sH1;                          // [128][kNC + 8]
#ifdef ABLATE_EPILOGUE
    if (acc[0][0][0] != 12345.0f) continue;    // keeps the products alive
#endif
    constexpr int ldo = kNC + 8;
    const int upr = nrows >> 3;                // 16-byte units a pixel
    if (!down) {
      const bool vec = (Cin & 7) == 0;
      for (int u = threadIdx.x; u < kTilePix * upr; u += kThreads) {
        const int p = u / upr;
        const int c8 = (u - p * upr) << 3;
        const int oy = y0 + (p >> 4);
        const int ox = x0 + (p & 15);
        const int n = n0 + c8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (oy < H && ox < W && n < Cin) {      // Cin == Cout here
          const bf16* src = xb + ((size_t)oy * W + ox) * Cin + n;
          if (vec) {
            v = *reinterpret_cast<const uint4*>(src);
          } else {
            const unsigned short* q =
                reinterpret_cast<const unsigned short*>(src);
            unsigned short e[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) e[k] = n + k < Cin ? q[k] : 0;
            v = make_uint4(e[0] | (uint32_t)e[1] << 16,
                           e[2] | (uint32_t)e[3] << 16,
                           e[4] | (uint32_t)e[5] << 16,
                           e[6] | (uint32_t)e[7] << 16);
          }
        }
        *reinterpret_cast<uint4*>(sOut + p * ldo + c8) = v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (wm * 4 + i) * 16 + g + half * 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < 2 * npairs) {
            const int c = wcol0 + j * 8 + t * 2;
            __nv_bfloat162* cell =
                reinterpret_cast<__nv_bfloat162*>(sOut + p * ldo + c);
            float v0 = acc[i][j][half * 2] + b3[n0 + c];
            float v1 = acc[i][j][half * 2 + 1] + b3[n0 + c + 1];
            if (down) {
              v0 += bd[n0 + c];
              v1 += bd[n0 + c + 1];
            } else {
              const float2 r = __bfloat1622float2(*cell);
              v0 += r.x;
              v1 += r.y;
            }
            *cell = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
        }
      }
    }
    __syncthreads();
    {
      const bool vec = (Cout & 7) == 0;
      for (int u = threadIdx.x; u < kTilePix * upr; u += kThreads) {
        const int p = u / upr;
        const int c8 = (u - p * upr) << 3;
        const int oy = y0 + (p >> 4);
        const int ox = x0 + (p & 15);
        const int n = n0 + c8;
        if (oy >= H || ox >= W || n >= Cout) continue;
        bf16* dst = y + (img + (size_t)oy * W + ox) * Cout + n;
        const bf16* src = sOut + p * ldo + c8;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (n + k < Cout) dst[k] = src[k];
        }
      }
    }
    __syncthreads();                 // sOut gives way to the next ring
  }
#endif
}

}  // namespace

// The kernel's builds, (K slice, ring depth), in order of preference: the
// first whose shared memory leaves room for a second block on the SM is
// taken, else the smallest.
struct Build {
  int ks, stages;
  void (*kernel)(const bf16*, bf16*, const bf16*, const float*, const bf16*,
                 const float*, const bf16*, const float*, const bf16*,
                 const float*, int, int, int, int, int, int);
};
static const Build kBuilds[] = {
#ifdef ABLATE_KS   // the one build asked for, whatever room it leaves
    {ABLATE_KS, ABLATE_S, bottleneck_kernel<ABLATE_KS, ABLATE_S>},
#else
    {64, 2, bottleneck_kernel<64, 2>},
    {32, 2, bottleneck_kernel<32, 2>},
#endif
};

static const Build* pick(int cmid_p, bool down, int* bytes) {
  const Build* best = nullptr;
  for (const Build& b : kBuilds) {
    const int need =
        smem_elems(cmid_p, down, b.ks, b.stages) * (int)sizeof(bf16);
    if (need <= kHalfSmem) {
      *bytes = need;
      return &b;
    }
    if (best == nullptr || need < *bytes) {
      best = &b;
      *bytes = need;
    }
  }
  return best;
}

// Bytes of dynamic shared memory a block needs at these widths; the
// wrapper refuses widths that need more than a block can have (232,448).
extern "C" int tpubody_fused_stage_smem_bytes(int Cmid, int has_down) {
  int bytes = 0;
  pick(round16(Cmid), has_down != 0, &bytes);
  return bytes;
}

// One bottleneck: launches the kernel on `stream` over grid (tiles, images)
// and returns cudaGetLastError().  Weights and biases are padded to
// multiples of 16 as described above (Cmid is the unpadded width); wd and
// bd are null for an identity residual.
extern "C" int tpubody_fused_stage_block(
    const void* x, void* y, const void* w1, const float* b1, const void* w2,
    const float* b2, const void* w3, const float* b3, const void* wd,
    const float* bd, int B, int H, int W, int Cin, int Cmid, int Cout,
    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int cmid_p = round16(Cmid);
  int bytes = 0;
  const Build* build = pick(cmid_p, wd != nullptr, &bytes);
  if (bytes > kMaxSmem || B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      build->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_y = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_x * tiles_y, B);
  build->kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y),
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
      static_cast<const bf16*>(w3), b3, static_cast<const bf16*>(wd), bd, H,
      W, Cin, cmid_p, Cout, tiles_x);
  return (int)cudaGetLastError();
}
