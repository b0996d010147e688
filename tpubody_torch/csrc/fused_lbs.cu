// fused_lbs: batched SMPL-family linear blend skinning on the tensor cores,
// one pass per (64-frame, 64-vertex) tile, for Hopper (sm_90a).
//
// Replaces: tpubody/core/pallas_lbs.py::_fused_kernel (the Pallas TPU
// kernel behind tpubody.models.smpl.forward_batch_verts).  It computes the
// same function; the TPU layout artefacts (frames-major (3, F, V) output,
// 16-row G slabs, 128-aligned padded tiles) are not carried over.
//
//   v[f, v, c] = sum_k feat[f, k] * basis[c, k, v]       (blendshaped rest
//                 vertex; feat = [pose_feat | betas | 1], basis =
//                 [posedirs | shapedirs | v_template] per coordinate c)
//   T[f, v, e] = sum_j g[f, j, e] * wT[j, v]             (the 3x4 top of
//                 the blended transform, e = row * 4 + col)
//   out[f, v, r] = T[.., r*4 + 0..2] . v[f, v, :] + T[.., r*4 + 3] + trans[f, r]
//
// What bounds it on an H100 SXM (data sheet: 989 TFLOP/s dense bf16 on the
// tensor cores, 3.35 TB/s HBM): at the flagship shape F = 512, V = 6890,
// J = 24, K = 218 the two contractions are 2 * (3 * 218 + 12 * 24) = 1,884
// operations a (frame, vertex), 6.65 GFLOP; "bf16x3" does each as three
// bf16 products, 19.9 GFLOP, 0.0214 ms at the bf16 rate (the apply step,
// 24 fp32 operations a point, adds 1.3 us on the CUDA cores).  The bytes
// it must move take 0.0185 ms: 42.3 MB of output, 18.0 MB of basis, the
// weights and the per-frame inputs.  So it sits at the ridge: bound by
// operations in bf16x3, and in "highest" (six products) twice as far.
//
// What the design does about it.  Both contractions are mma.sync m16n8k16
// (bf16 in, f32 sums), with M over frames and N over vertices.  mma.sync
// rather than wgmma: the operands are read once per block straight from L2
// into registers (no shared-memory staging, no descriptors), the work per
// block is small (K = 224 for the basis, 32 for the weights), and the 15
// accumulators a (frame, vertex) needs (3 for v, 12 for T) would not fit a
// wgmma tile's register budget.  Each contraction is split into one
// product per coordinate c (3) and per transform entry e (12), so that the
// accumulator fragments of v and of every T entry for one (frame, vertex)
// land in the same register of the same thread, and the apply step needs
// no exchange between threads: a thread blends its T entry by entry
// straight into the output (out_r += T_re * v_e), so only 3 x 4 sums of v,
// 4 of T and 4 of out stay live per fragment.
//   * Operands are split once, outside every loop, into bf16 planes in
//     the order of the mma fragments, so that a lane loads one 16-byte word
//     per (plane, k step, fragment) and the products split nothing.  The
//     model's basis and weights (hi, lo, lo2) when the model's layouts are
//     built (core/fused_lbs.py model_layouts).  The per-frame feat and g
//     (hi, lo, and lo2 for "highest" only) by split_frames_kernel, a pass
//     of the same entry point just before the products: 1.2 MB at F = 512,
//     into a buffer the wrapper allocates.  Splitting them in registers as
//     the products load them instead repeats the split in every vertex
//     tile (108 blocks x 4 warps a fragment); at about 40 instructions a
//     fragment against 6 to 36 mma.sync each, that measured 2.2 to 2.6x
//     slower.  K is padded with zeros to 224 (14 k steps), J to 32, frames
//     and vertices to multiples of 64.
//   * A block is 8 warps over 64 frames x 64 vertices: a warp owns 32
//     frames (2 row tiles) x 16 vertices (2 column tiles).  Each basis
//     fragment is read from L2 once per frame tile, F / 64 = 8 times in
//     all (64 with 8-frame tiles), and serves 2 row tiles from registers.
//   * The output goes through shared memory: each thread writes its
//     values, then each warp writes whole rows (one frame, 64 vertices x
//     3 coordinates, 768 contiguous bytes) in 16-byte stores, with scalar
//     stores only for the unaligned head and tail of a row.  The ragged
//     frame and vertex edges are masked there; the output is not padded.
//
// Precision (bf16 keeps 8 significant bits: |x - bf16(x)| <= 2^-8 |x|).
// "bf16x3": x = hi + lo + r with hi = bf16(x), lo = bf16(x - hi), |r| <=
// 2^-16 |x|; hi*hi + hi*lo + lo*hi leave out lo*lo and the r terms, about
// 2^-15 of each term, and sum in f32: the function of _dot3
// (tpubody/core/pallas_lbs.py:48-60), with its planes bit for bit; the
// plain version is held to it at a relative 1e-4.  "highest": a third
// plane lo2 = bf16(x - hi - lo), |x - hi - lo - lo2| <= 2^-24 |x|, and the
// six products hi*hi, hi*lo, lo*hi, hi*lo2, lo2*hi, lo*lo (the six-pass
// bf16 that Precision.HIGHEST is on the TPU's matrix unit); what they
// leave out is a few units of 2^-24 of each term, f32 rounding, so the
// result is an fp32 product in another summation order, held to the fp32
// torch.matmul at max |d| < 2e-5.  Each bf16 x bf16 product is exact in
// f32; the smallest products go first.
//
// The wrapper (tpubody_torch/core/fused_lbs.py) allocates the output and
// the frames' planes; the kernels run on the caller's stream, allocate
// nothing, synchronise nothing, and the entry point returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kBF = 64;         // frames a block
constexpr int kBV = 64;         // vertices a block
constexpr int kLdo = kBV * 3 + 4;   // staging row, floats (16-byte rows)
constexpr int kSmem = kBF * kLdo * (int)sizeof(float);

__device__ __forceinline__ void mma(float (&c)[4], const uint4& a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// bf16x2 of (lo, hi), lo in the lower half; and each half widened back.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lower(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float upper(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// The per-frame rows as the products' A operand, split into P planes: one
// warp a (16-frame row tile, item) fragment, item s < KS k step s of feat
// (F, K), item KS + e * JS + s k step s of entry e of g (F, J, 12).  Lane
// (g, t) writes word (m, item, lane) of each plane: register q = kh * 2 +
// rh holds frame 16 m + 8 rh + g, columns 16 s + 8 kh + 2 t + (0, 1) (the
// lower bf16 first), zero past F, K and J.  Each residual x - bf16(x) is
// exact in f32, so the planes are split_planes' (core/fused_lbs.py) bit
// for bit.
template <int P>
__global__ void __launch_bounds__(256)
split_frames_kernel(const float* __restrict__ feat,
                    const float* __restrict__ gm, uint4* __restrict__ frm,
                    int F, int K, int J, int KS, int JS, int n_frag,
                    size_t fplane) {
  const int frag = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (frag >= n_frag) return;
  const int IF = KS + 12 * JS;
  const int m = frag / IF, item = frag % IF;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // feat: rows of K, columns contiguous; g entry e: rows of 12 J, columns
  // 12 apart
  const bool is_feat = item < KS;
  const float* base = is_feat ? feat : gm + (item - KS) / JS;
  const size_t ld = is_feat ? (size_t)K : (size_t)J * 12;
  const int cols = is_feat ? K : J, cs = is_feat ? 1 : 12;
  const int s = is_feat ? item : (item - KS) % JS;
  uint32_t w[P][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int f = 16 * m + 8 * (q & 1) + g;
    const int c = 16 * s + 8 * (q >> 1) + 2 * t;
    float x0 = 0.0f, x1 = 0.0f;
    if (f < F) {
      const float* row = base + f * ld;
      if (c < cols) x0 = __ldg(row + (size_t)c * cs);
      if (c + 1 < cols) x1 = __ldg(row + (size_t)(c + 1) * cs);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t u = bf16x2(x0, x1);
      w[p][q] = u;
      x0 -= lower(u);
      x1 -= upper(u);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
    frm[p * fplane + (size_t)frag * 32 + lane] =
        make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
}

// c += a . b over the split planes: P = 2 is bf16x3 (lo*hi, hi*lo, hi*hi),
// P = 3 "highest" (lo2*hi, hi*lo2, lo*lo, lo*hi, hi*lo, hi*hi), smallest
// first.  b: column tile `n` of the plane's 16-byte word (x, y or z, w).
template <int P>
__device__ __forceinline__ void mma_split(float (&c)[4], const uint4 (&a)[P],
                                          const uint4 (&b)[P], int n) {
  auto b0 = [&](int p) { return n ? b[p].z : b[p].x; };
  auto b1 = [&](int p) { return n ? b[p].w : b[p].y; };
  if constexpr (P == 3) {
    mma(c, a[2], b0(0), b1(0));
    mma(c, a[0], b0(2), b1(2));
    mma(c, a[1], b0(1), b1(1));
  }
  mma(c, a[1], b0(0), b1(0));
  mma(c, a[0], b0(1), b1(1));
  mma(c, a[0], b0(0), b1(0));
}

// vtx: (3 planes, V/16, IV, 32 lanes) 16-byte words, IV = 3 * KS + JS
//      items: basis coordinate c, k step s at c * KS + s; weights, k step
//      s at 3 * KS + s.  Word of lane (g, t): column tile 0 (b0, b1), then
//      column tile 1, of vertices 16 * tile + {0, 8} + g.
// frm: (P planes, F/16, IF, 32 lanes) 16-byte words, IF = KS + 12 * JS
//      items: feat, k step s at s; g entry e, k step s at KS + e * JS + s.
//      Word of lane (g, t): the A fragment (a0, a1, a2, a3), written by
//      split_frames_kernel.
// vplane, fplane: words a plane.
template <int P>
__global__ void __launch_bounds__(kThreads, 2)
fused_lbs_kernel(const uint4* __restrict__ vtx, const uint4* __restrict__ frm,
                 const float* __restrict__ trans, float* __restrict__ out,
                 int F, int V, int KS, int JS, size_t vplane, size_t fplane) {
  extern __shared__ __align__(16) float sOut[];   // [kBF][kLdo]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2;        // 0..1: frames wm * 32 ..
  const int wn = warp & 3;         // 0..3: vertices wn * 16 ..
  const int f0 = blockIdx.y * kBF, v0 = blockIdx.x * kBV;
  const int IV = 3 * KS + JS, IF = KS + 12 * JS;
  const uint4* vb = vtx + ((size_t)(blockIdx.x * 4 + wn) * IV) * 32 + lane;
  const uint4* fb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    fb[i] = frm + ((size_t)(blockIdx.y * 4 + wm * 2 + i) * IF) * 32 + lane;

  // ---- v = feat . basis, per coordinate
  float v[3][2][2][4];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[c][i][n][q] = 0.0f;
#pragma unroll 2
  for (int s = 0; s < KS; ++s) {
    uint4 a[2][P];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int p = 0; p < P; ++p) a[i][p] = __ldg(fb[i] + p * fplane + s * 32);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint4 b[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        b[p] = __ldg(vb + p * vplane + (c * KS + s) * 32);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_split<P>(v[c][i][n], a[i], b, n);
    }
  }

  // ---- T = g . wT entry by entry, applied as it comes: out_r = sum_e
  // T_re * v_e + T_r3 + trans_r, staged in shared memory
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll 1
    for (int r = 0; r < 3; ++r) {
      float o[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) o[n][q] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float T[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) T[n][q] = 0.0f;
        for (int s = 0; s < JS; ++s) {
          uint4 a[P], b[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            a[p] = __ldg(fb[i] + p * fplane + (KS + (r * 4 + e) * JS + s) * 32);
            b[p] = __ldg(vb + p * vplane + (3 * KS + s) * 32);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) mma_split<P>(T[n], a, b, n);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            o[n][q] = e < 3 ? fmaf(T[n][q], v[e < 3 ? e : 0][i][n][q], o[n][q])
                            : o[n][q] + T[n][q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int fl = wm * 32 + i * 16 + g + 8 * (q >> 1);
        const float tr = trans != nullptr && f0 + fl < F
                             ? __ldg(trans + (size_t)(f0 + fl) * 3 + r)
                             : 0.0f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int vl = wn * 16 + n * 8 + 2 * t + (q & 1);
          sOut[fl * kLdo + vl * 3 + r] = o[n][q] + tr;
        }
      }
    }
  }
  __syncthreads();

  // ---- rows out: one frame's 64 vertices x 3 are contiguous in (F, V, 3)
  const int L = min(kBV, V - v0) * 3;
  for (int fl = warp; fl < kBF; fl += kThreads / 32) {
    const int f = f0 + fl;
    if (f >= F) break;
    const size_t gs = ((size_t)f * V + v0) * 3;
    const int head = min(L, (int)((4 - (gs & 3)) & 3));
    const int nb = (L - head) >> 2;
    const float* src = sOut + fl * kLdo;
    float* dst = out + gs;
    if (lane < head) dst[lane] = src[lane];
    for (int u = lane; u < nb; u += 32) {
      const int o = head + 4 * u;
      float4 w;
      if (head & 1) {
        w = make_float4(src[o], src[o + 1], src[o + 2], src[o + 3]);
      } else if (head & 2) {
        const float2 lo = *reinterpret_cast<const float2*>(src + o);
        const float2 hi = *reinterpret_cast<const float2*>(src + o + 2);
        w = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        w = *reinterpret_cast<const float4*>(src + o);
      }
      *reinterpret_cast<float4*>(dst + o) = w;
    }
    const int rest = head + 4 * nb;
    if (lane < L - rest) dst[rest + lane] = src[rest + lane];
  }
}

template <int P>
cudaError_t launch(const void* vtx, const float* feat, const float* gm,
                   void* frm, const float* trans, float* out, int F, int V,
                   int K, int J, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_lbs_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int KS = (K + 15) / 16, JS = (J + 15) / 16;
  const int VT = (V + kBV - 1) / kBV, FT = (F + kBF - 1) / kBF;
  const size_t vplane = (size_t)VT * 4 * (3 * KS + JS) * 32;
  const int n_frag = FT * 4 * (KS + 12 * JS);
  const size_t fplane = (size_t)n_frag * 32;
  split_frames_kernel<P><<<(n_frag + 7) / 8, 256, 0, stream>>>(
      feat, gm, static_cast<uint4*>(frm), F, K, J, KS, JS, n_frag, fplane);
  const dim3 grid(VT, FT);
  fused_lbs_kernel<P><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const uint4*>(vtx), static_cast<const uint4*>(frm), trans,
      out, F, V, KS, JS, vplane, fplane);
  return cudaGetLastError();
}

}  // namespace

// vtx: the model's split planes (3, bf16 in fragment order, see above;
// vertices padded to a multiple of 64); feat (F, K), g (F, J, 12) and trans
// (F, 3) fp32, trans may be null; frm: room for the frames' planes, 2
// ("bf16x3", split = 1) or 3 ("highest", split = 0) planes of
// ceil(F / 64) * 4 * (KS + 12 * JS) * 32 16-byte words.  Two launches on
// `stream`: the split of the frames, then the products.  Returns
// cudaGetLastError() after them.
extern "C" int tpubody_fused_lbs(const void* vtx, const float* feat,
                                 const float* g, void* frm,
                                 const float* trans, float* out, int F, int V,
                                 int K, int J, int split,
                                 cudaStream_t stream) {
  if (F <= 0 || V <= 0) return (int)cudaSuccess;
  if (F > 65535 * kBF) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      split ? launch<2>(vtx, feat, g, frm, trans, out, F, V, K, J, stream)
            : launch<3>(vtx, feat, g, frm, trans, out, F, V, K, J, stream);
  return (int)err;
}

extern "C" const char* tpubody_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
