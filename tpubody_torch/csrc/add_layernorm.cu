// add_layernorm: a pre-norm transformer's residual add, the LayerNorm after
// it and the cast of its output to the next Linear's dtype, in one pass,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: tpubody has no transformer.  It was added for
// HMR 2.0's ViT-H encoder (tpubody_torch/models/hmr2.py), whose blocks ran
// the add, the LayerNorm and the cast as three eager passes over the same
// rows: the add reads float32 x and the branch and writes x, the LayerNorm
// reads x and writes a float32 output that nothing keeps, and the cast
// reads it again.  At 512 frames (98,304 tokens of 1280) that is 3.02 GB an
// add + LayerNorm pair, 64 pairs a batch.
//
// It computes, for row m of x (M, D) float32, branch (M, D) bf16 or
// float32 and an optional float32 per-channel scale gamma (D) on the
// branch (add_layernorm_reference in hmr2.py is the eager chain):
//   x_new[m] = fl(x[m] + float(branch[m]))      written if x_out is given
//            = fl(x[m] + fl(gamma * float(branch[m])))   with a scale
//   mean     = sum(x_new[m]) / D
//   rstd     = rsqrt(sum((x_new[m] - mean)^2) / D + eps)
//   h_out[m] = weight * ((x_new[m] - mean) * rstd) + bias, rounded to bf16
//              (nearest even) or kept float32
// The add is one __fadd_rn (after one __fmul_rn with a scale), so x_new
// has the bits of the eager x + branch (x + gamma * branch).  A scale is
// DINOv2's LayerScale (Multi-HMR's encoder, models/multihmr.py): the
// kernel without one is the same instantiation as before it took one.
// The statistics are float32, as F.layer_norm's on the card, summed in
// another order, so the normalised row may differ from it in the last
// bits of float32.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM): bytes.  An element reads 4
// bytes of x and 2 of a bf16 branch and writes 4 of x_new and 2 of bf16
// output for about 10 operations, far below the ridge.  At 98,304 x 1280
// that is 1.51 GB, 0.45 ms; the eager chain moves twice as much.
//
// What the design does about it: every byte is read or written once, and
// no intermediate goes to device memory.  One warp takes one row and holds
// it in registers: a lane takes kPerLane chunks of 8 elements (40 floats at
// D = 1280), chunk c in lane c % 32, so that each warp load is contiguous
// (1 KB of x, 512 bytes of a bf16 branch).  All loads of a row are 16 bytes
// and issued before any arithmetic, through the read-only cache (the
// streaming hint, __ldcs, measured 2.4% slower on an H100 at this shape).
// The mean and then the variance about it are two passes over the
// registers, reduced with warp shuffles: no shared memory, no barrier.
// weight and bias come as float4 through the read-only cache, and every
// store is 16 bytes.  kPerLane is a template constant (1 to 8, so D up to
// 2048), which keeps the row in registers; where D / 8 is not a multiple
// of 32, a lane's last chunk may lie past the row's end and is neither
// loaded nor summed.  The kernel runs on the caller's stream and allocates
// and synchronises nothing; the entry point returns the launch's error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // rows a block
constexpr int kChunk = 8;        // elements a chunk (16 bytes of bf16)
constexpr int kMaxPerLane = 8;   // D up to 32 * 8 * 8 = 2048

// A chunk of the branch as loaded: 16 bytes of bf16 or 32 of float32.
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint4 a; };
template <> struct Raw<float> { float4 a, b; };

__device__ __forceinline__ void load(Raw<__nv_bfloat16>& r,
                                     const __nv_bfloat16* p) {
  r.a = __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void load(Raw<float>& r, const float* p) {
  r.a = __ldg(reinterpret_cast<const float4*>(p));
  r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

// bf16 -> float is exact: the bf16 bits are a float's upper half.
__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r,
                                      float* v) {
  const unsigned w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(const Raw<float>& r, float* v) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

__device__ __forceinline__ void store(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  uint4 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename B, typename O, int kPerLane, bool kScale>
__global__ void __launch_bounds__(kWarps * 32)
add_layernorm_kernel(const float* __restrict__ x,        // (M, D)
                     const B* __restrict__ branch,       // (M, D)
                     const float* __restrict__ scale,    // (D) if kScale
                     const float* __restrict__ weight,   // (D)
                     const float* __restrict__ bias,     // (D)
                     float* __restrict__ x_out,          // (M, D) or null
                     O* __restrict__ h_out,              // (M, D)
                     int M, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;                     // the whole warp leaves
  const int chunks = D / kChunk;
  const long long base = row * D;
  float v[kPerLane][kChunk];
  Raw<B> raw[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) {
      load(raw[k], branch + base + c * kChunk);
      const float4* p = reinterpret_cast<const float4*>(x + base + c * kChunk);
      const float4 a = __ldg(p), b = __ldg(p + 1);
      v[k][0] = a.x; v[k][1] = a.y; v[k][2] = a.z; v[k][3] = a.w;
      v[k][4] = b.x; v[k][5] = b.y; v[k][6] = b.z; v[k][7] = b.w;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (lane + 32 * k < chunks) {
      float w[kChunk];
      widen(raw[k], w);
      if constexpr (kScale) {
        const float4* g4 =
            reinterpret_cast<const float4*>(scale + (lane + 32 * k) * kChunk);
        const float4 g0 = __ldg(g4), g1 = __ldg(g4 + 1);
        const float g[kChunk] = {g0.x, g0.y, g0.z, g0.w,
                                 g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int j = 0; j < kChunk; ++j) w[j] = __fmul_rn(g[j], w[j]);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        v[k][j] = __fadd_rn(v[k][j], w[j]);
        s += v[k][j];
      }
    }
  }
  const float mean = __fdiv_rn(warp_sum(s), (float)D);
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (lane + 32 * k < chunks) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float d = v[k][j] - mean;
        q = fmaf(d, d, q);
      }
    }
  }
  const float rstd = rsqrtf(__fdiv_rn(warp_sum(q), (float)D) + eps);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) {
      const long long at = base + c * kChunk;
      if (x_out) store(x_out + at, v[k]);
      const float4* w4 = reinterpret_cast<const float4*>(weight + c * kChunk);
      const float4* b4 = reinterpret_cast<const float4*>(bias + c * kChunk);
      const float4 w0 = __ldg(w4), w1 = __ldg(w4 + 1);
      const float4 b0 = __ldg(b4), b1 = __ldg(b4 + 1);
      const float w[kChunk] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float b[kChunk] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float h[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        h[j] = fmaf(w[j], (v[k][j] - mean) * rstd, b[j]);
      store(h_out + at, h);
    }
  }
}

template <typename B, typename O, bool kScale, int kPerLane>
void launch(int per_lane, unsigned blocks, cudaStream_t stream,
            const float* x, const void* branch, const float* scale,
            const float* weight, const float* bias, float* x_out,
            void* h_out, int M, int D, float eps) {
  if (per_lane == kPerLane) {
    add_layernorm_kernel<B, O, kPerLane, kScale>
        <<<blocks, kWarps * 32, 0, stream>>>(
            x, static_cast<const B*>(branch), scale, weight, bias, x_out,
            static_cast<O*>(h_out), M, D, eps);
  } else if constexpr (kPerLane < kMaxPerLane) {
    launch<B, O, kScale, kPerLane + 1>(per_lane, blocks, stream, x, branch,
                                       scale, weight, bias, x_out, h_out, M,
                                       D, eps);
  }
}

template <typename B, typename O>
void launch_scale(int per_lane, unsigned blocks, cudaStream_t stream,
                  const float* x, const void* branch, const float* scale,
                  const float* weight, const float* bias, float* x_out,
                  void* h_out, int M, int D, float eps) {
  if (scale)
    launch<B, O, true, 1>(per_lane, blocks, stream, x, branch, scale, weight,
                          bias, x_out, h_out, M, D, eps);
  else
    launch<B, O, false, 1>(per_lane, blocks, stream, x, branch, scale,
                           weight, bias, x_out, h_out, M, D, eps);
}

template <typename B>
void launch_out(int out_bf16, int per_lane, unsigned blocks,
                cudaStream_t stream, const float* x, const void* branch,
                const float* scale, const float* weight, const float* bias,
                float* x_out, void* h_out, int M, int D, float eps) {
  if (out_bf16)
    launch_scale<B, __nv_bfloat16>(per_lane, blocks, stream, x, branch,
                                   scale, weight, bias, x_out, h_out, M, D,
                                   eps);
  else
    launch_scale<B, float>(per_lane, blocks, stream, x, branch, scale,
                           weight, bias, x_out, h_out, M, D, eps);
}

}  // namespace

// x (M, D) float32; branch (M, D) bf16 if branch_bf16 else float32;
// scale (D,) float32 or null (no scale on the branch); weight, bias (D,)
// float32; x_out (M, D) float32 or null (x_new is then
// not written); h_out (M, D) bf16 if out_bf16 else float32.  All row-major
// and 16-byte aligned, x_out apart from x; D a multiple of 8 from 8 to
// 2048; M below 2^31.  One launch on `stream`; returns cudaGetLastError()
// after it.
extern "C" int tpubody_add_layernorm(const float* x, const void* branch,
                                     int branch_bf16, const float* scale,
                                     const float* weight,
                                     const float* bias, float eps,
                                     float* x_out, void* h_out, int out_bf16,
                                     int M, int D, cudaStream_t stream) {
  if (M < 0 || D < kChunk || D % kChunk != 0 ||
      D > 32 * kChunk * kMaxPerLane)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const int per_lane = (D / kChunk + 31) / 32;
  const unsigned blocks = (unsigned)(((long long)M + kWarps - 1) / kWarps);
  if (branch_bf16)
    launch_out<__nv_bfloat16>(out_bf16, per_lane, blocks, stream, x, branch,
                              scale, weight, bias, x_out, h_out, M, D, eps);
  else
    launch_out<float>(out_bf16, per_lane, blocks, stream, x, branch, scale,
                      weight, bias, x_out, h_out, M, D, eps);
  return (int)cudaGetLastError();
}
