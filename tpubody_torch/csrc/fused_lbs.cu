// fused_lbs: batched SMPL-family linear blend skinning, one pass per
// (vertex tile, frame tile), for Hopper (sm_90a).
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
// What bounds it on an H100 SXM (data sheet: 3.35 TB/s HBM, 67 TFLOP/s
// fp32 outside the tensor cores): at the flagship shape F = 512 frames,
// V = 6890, J = 24, K = 218 one (frame, vertex) costs ~1,900 fp32 FLOP
// (1,308 blendshape + 576 blend + ~24 apply), 6.7 GFLOP in all, ~100 us
// on the CUDA cores; the bytes it must move are ~62 MB (42.3 MB output,
// 18.0 MB basis, 0.7 MB weights, ~1 MB per-frame inputs), ~18.5 us.  So on
// CUDA cores the kernel is bound by operations; "bf16x3" triples the
// multiply-adds of the two contractions (hi*hi + hi*lo + lo*hi) and is
// three times further from the memory bound.  A tensor-core (mma/wgmma
// bf16) version of the split would be memory-bound; that is later work.
//
// What the design does about it: one thread per vertex, 128 vertices and
// 8 frames per block.  The block stages its frames' features (transposed
// to [k][frame], so one k reads the 8 frames with two 16-byte shared
// loads, a broadcast) and their 3x4 transforms in shared memory; in the
// bf16x3 mode they are staged already split into hi and lo parts.  Each
// thread streams its vertex's K basis columns once per frame tile (the
// 18 MB basis stays resident in the 50 MB L2 across frame tiles), keeping
// 3 x 8 sums in registers, so DRAM traffic is about one read of the basis
// and one write of the output.  It then blends its J weights into the 12
// transform entries frame by frame, applies them, adds trans and writes
// (F, V, 3) directly.  Both ragged edges are masked; nothing is padded.
// The wrapper (tpubody_torch/core/fused_lbs.py) allocates the output; the
// kernel runs on the caller's stream, allocates nothing, synchronises
// nothing, and the entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // vertices per block, one per thread
constexpr int kFrames = 8;     // frames per block

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
fused_lbs_kernel(const float* __restrict__ basis,  // (3, K, V)
                 const float* __restrict__ wT,     // (J, V)
                 const float* __restrict__ feat,   // (F, K)
                 const float* __restrict__ g,      // (F, J, 12)
                 const float* __restrict__ trans,  // (F, 3) or nullptr
                 float* __restrict__ out,          // (F, V, 3)
                 int F, int V, int K, int J) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kParts = kSplit ? 2 : 1;
  const int JE = J * 12;
  // feat_s[part][k][frame], g_s[part][frame][j * 12 + e]
  float* feat_s = smem;
  float* g_s = smem + kParts * K * kFrames;
  const int f0 = blockIdx.y * kFrames;
  const int nf = min(kFrames, F - f0);

  for (int i = threadIdx.x; i < kFrames * K; i += kThreads) {
    const int f = i / K, k = i - f * K;
    const float x = f < nf ? feat[(size_t)f0 * K + i] : 0.f;
    if (kSplit) {
      const float hi = bf16_round(x);
      feat_s[k * kFrames + f] = hi;
      feat_s[(K + k) * kFrames + f] = bf16_round(x - hi);
    } else {
      feat_s[k * kFrames + f] = x;
    }
  }
  for (int i = threadIdx.x; i < kFrames * JE; i += kThreads) {
    const int f = i / JE;
    const float x = f < nf ? g[(size_t)f0 * JE + i] : 0.f;
    if (kSplit) {
      const float hi = bf16_round(x);
      g_s[i] = hi;
      g_s[kFrames * JE + i] = bf16_round(x - hi);
    } else {
      g_s[i] = x;
    }
  }
  __syncthreads();

  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;

  // Blendshaped rest vertex of each frame, in registers.
  float acc[kFrames][3];
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[f][c] = 0.f;
  }
  const size_t plane = (size_t)K * V;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float b[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) b[c] = __ldg(basis + c * plane + (size_t)k * V + v);
    const float4* fs = reinterpret_cast<const float4*>(feat_s + k * kFrames);
    const float4 h0 = fs[0], h1 = fs[1];
    const float ah[kFrames] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    if (kSplit) {
      const float4* fl = reinterpret_cast<const float4*>(feat_s + (K + k) * kFrames);
      const float4 l0 = fl[0], l1 = fl[1];
      const float al[kFrames] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      float bh[3], bl[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        bh[c] = bf16_round(b[c]);
        bl[c] = bf16_round(b[c] - bh[c]);
      }
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[f][c] = fmaf(ah[f], bh[c], fmaf(ah[f], bl[c], fmaf(al[f], bh[c], acc[f][c])));
      }
    } else {
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[f][c] = fmaf(ah[f], b[c], acc[f][c]);
      }
    }
  }

  // Blend the 3x4 transforms and apply them, frame by frame.
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    if (f >= nf) break;
    float T[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) T[e] = 0.f;
    const float* gh = g_s + f * JE;
    const float* gl = g_s + (kFrames + f) * JE;
    for (int j = 0; j < J; ++j) {
      const float w = __ldg(wT + (size_t)j * V + v);
      const float4* gh4 = reinterpret_cast<const float4*>(gh + j * 12);
      const float4 p0 = gh4[0], p1 = gh4[1], p2 = gh4[2];
      const float gv[12] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y,
                            p1.z, p1.w, p2.x, p2.y, p2.z, p2.w};
      if (kSplit) {
        const float4* gl4 = reinterpret_cast<const float4*>(gl + j * 12);
        const float4 q0 = gl4[0], q1 = gl4[1], q2 = gl4[2];
        const float gvl[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                               q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
        const float wh = bf16_round(w), wl = bf16_round(w - wh);
#pragma unroll
        for (int e = 0; e < 12; ++e)
          T[e] = fmaf(gv[e], wh, fmaf(gv[e], wl, fmaf(gvl[e], wh, T[e])));
      } else {
#pragma unroll
        for (int e = 0; e < 12; ++e) T[e] = fmaf(gv[e], w, T[e]);
      }
    }
    const size_t frame = (size_t)f0 + f;
    const float x = acc[f][0], y = acc[f][1], z = acc[f][2];
    float t[3] = {0.f, 0.f, 0.f};
    if (trans != nullptr) {
#pragma unroll
      for (int r = 0; r < 3; ++r) t[r] = trans[frame * 3 + r];
    }
    float* o = out + (frame * V + v) * 3;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      o[r] = T[r * 4] * x + T[r * 4 + 1] * y + T[r * 4 + 2] * z + T[r * 4 + 3] + t[r];
  }
}

template <bool kSplit>
cudaError_t launch(const float* basis, const float* wT, const float* feat,
                   const float* g, const float* trans, float* out, int F,
                   int V, int K, int J, cudaStream_t stream) {
  const int parts = kSplit ? 2 : 1;
  const size_t smem = (size_t)parts * kFrames * (K + 12 * J) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_lbs_kernel<kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((V + kThreads - 1) / kThreads, (F + kFrames - 1) / kFrames);
  fused_lbs_kernel<kSplit><<<grid, kThreads, smem, stream>>>(
      basis, wT, feat, g, trans, out, F, V, K, J);
  return cudaGetLastError();
}

}  // namespace

// split = 0: "highest" (fp32 FMAs); split = 1: "bf16x3" (hi/lo bf16 split
// of both operands of both contractions, three products accumulated in
// fp32).  trans may be null.  Returns cudaGetLastError() after the launch.
extern "C" int tpubody_fused_lbs(const float* basis, const float* wT,
                                 const float* feat, const float* g,
                                 const float* trans, float* out, int F, int V,
                                 int K, int J, int split, cudaStream_t stream) {
  if (F <= 0 || V <= 0) return (int)cudaSuccess;
  const cudaError_t err =
      split ? launch<true>(basis, wT, feat, g, trans, out, F, V, K, J, stream)
            : launch<false>(basis, wT, feat, g, trans, out, F, V, K, J, stream);
  return (int)err;
}

extern "C" const char* tpubody_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
