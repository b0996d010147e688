// int8_requant: the int8 backbone's requantizing epilogue, one pass from a
// convolution's int32 sums to what the next layer reads, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: tpubody leaves its int8 convolution, the
// dequantize and the next quantize to XLA.  It was added because the
// port's eager chain between two int8 convolutions (acc.float(), the scale
// multiply, the bias, ReLU, the residual add and its ReLU, then divide,
// round, clamp and cast once for each consumer) makes about ten passes
// over float32 activations where one is enough.
//
// It computes, for row m and channel o of one convolution's sums acc
// (M, O), exactly the float32 operations of that chain, in its order
// (tpubody_torch/models/hmr_quant.py, requantize_reference):
//   s = fl(x_scale * w_scale[o])
//   y = fl(fl(float(acc[m, o]) * s) + b[o]),  then max(y, 0) if relu
//   y = max(fl(y + res[m, o]), 0)             if res is given (conv3)
//   out[m, o]     = y                         if out is given
//   codes_k[m, o] = clamp(rint(fl(y / next_k)), -127, 127), k < 2
// Each step is an __*_rn intrinsic, so nvcc contracts nothing into a fused
// multiply-add, the division is a true one and rintf rounds half to even:
// the same bits as the eager chain on the card.  The scales are 0-d device
// tensors read through pointers, never synchronised to the host.
//
// What bounds it on an H100 SXM (data sheet: 3.35 TB/s HBM): bytes.  An
// element reads 4 bytes of sums (and 4 of residual) and writes 1 byte a
// code tensor (and 4 of float output) for about 10 operations, far below
// the ridge.  The ResNet-50 backbone at 512 frames of 224^2 moves 52.4 GB
// through its 53 launches, 15.6 ms.
//
// What the design does about it: every byte is read or written once, with
// no float32 intermediate in device memory.  A thread takes kUnroll
// 16-byte vectors of 4 channels, kThreads vectors apart, so that each warp
// load and store is contiguous (512 bytes of sums, 128 of codes); all its
// loads are issued before the arithmetic, and the sums and residuals, read
// once, with the streaming hint.  Four codes are packed into one 32-bit
// store.  The per-channel scale and bias come as float4 through the
// read-only cache.  The kernel runs on the caller's stream, allocates and
// synchronises nothing; the entry point returns the launch's error.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float affine(int a, float xs, float ws, float b,
                                        int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(a), __fmul_rn(xs, ws)),
                            b);
  return relu ? fmaxf(y, 0.f) : y;
}

__device__ __forceinline__ unsigned code(float y, float s, int shift) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
  return ((unsigned)__float2int_rn(q) & 0xffu) << shift;
}

__device__ __forceinline__ unsigned pack(const float4& y, float s) {
  return code(y.x, s, 0) | code(y.y, s, 8) | code(y.z, s, 16) |
         code(y.w, s, 24);
}

__global__ void __launch_bounds__(kThreads)
int8_requant_kernel(const int4* __restrict__ acc,        // (M, O / 4)
                    const float4* __restrict__ w_scale,  // (O / 4)
                    const float* __restrict__ x_scale,   // ()
                    const float4* __restrict__ bias,     // (O / 4)
                    const float4* __restrict__ res,      // (M, O / 4) or null
                    const float* __restrict__ next0,     // () or null
                    const float* __restrict__ next1,     // () or null
                    unsigned* __restrict__ codes0,       // (M, O / 4) or null
                    unsigned* __restrict__ codes1,       // (M, O / 4) or null
                    float4* __restrict__ out,            // (M, O / 4) or null
                    unsigned n_vec, unsigned groups, int relu) {
  const unsigned base = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  int4 a[kUnroll];
  float4 r[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const unsigned v = base + k * kThreads;
    if (v < n_vec) {
      a[k] = __ldcs(acc + v);
      if (res) r[k] = __ldcs(res + v);
    }
  }
  const float xs = __ldg(x_scale);
  const float s0 = codes0 ? __ldg(next0) : 1.f;
  const float s1 = codes1 ? __ldg(next1) : 1.f;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const unsigned v = base + k * kThreads;
    if (v >= n_vec) break;
    const unsigned g = v % groups;
    const float4 ws = __ldg(w_scale + g);
    const float4 b = __ldg(bias + g);
    float4 y = make_float4(affine(a[k].x, xs, ws.x, b.x, relu),
                           affine(a[k].y, xs, ws.y, b.y, relu),
                           affine(a[k].z, xs, ws.z, b.z, relu),
                           affine(a[k].w, xs, ws.w, b.w, relu));
    if (res) {
      y.x = fmaxf(__fadd_rn(y.x, r[k].x), 0.f);
      y.y = fmaxf(__fadd_rn(y.y, r[k].y), 0.f);
      y.z = fmaxf(__fadd_rn(y.z, r[k].z), 0.f);
      y.w = fmaxf(__fadd_rn(y.w, r[k].w), 0.f);
    }
    if (out) out[v] = y;
    if (codes0) codes0[v] = pack(y, s0);
    if (codes1) codes1[v] = pack(y, s1);
  }
}

}  // namespace

// acc (M, O) int32; w_scale, bias (O,) and x_scale () float32; res (M, O)
// float32 or null; next0 / next1 () float32 with codes0 / codes1 (M, O)
// int8, or null; out (M, O) float32 or null.  All row-major; acc, res,
// w_scale, bias and out 16-byte aligned; O a multiple of 4 and M * O / 4
// below 2^31.  One launch on `stream`; returns cudaGetLastError() after it.
extern "C" int tpubody_int8_requant(const int* acc, const float* w_scale,
                                    const float* x_scale, const float* bias,
                                    const float* res, const float* next0,
                                    const float* next1, int8_t* codes0,
                                    int8_t* codes1, float* out, int M, int O,
                                    int relu, cudaStream_t stream) {
  if (M <= 0) return (int)cudaSuccess;
  const long long n_vec = (long long)M * O / 4;
  if (O <= 0 || O % 4 != 0 || n_vec >= (1LL << 31) ||
      (codes0 != nullptr) != (next0 != nullptr) ||
      (codes1 != nullptr) != (next1 != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long per_block = kThreads * kUnroll;
  const unsigned blocks = (unsigned)((n_vec + per_block - 1) / per_block);
  int8_requant_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(acc),
      reinterpret_cast<const float4*>(w_scale), x_scale,
      reinterpret_cast<const float4*>(bias),
      reinterpret_cast<const float4*>(res), next0, next1,
      reinterpret_cast<unsigned*>(codes0), reinterpret_cast<unsigned*>(codes1),
      reinterpret_cast<float4*>(out), (unsigned)n_vec, (unsigned)(O / 4),
      relu);
  return (int)cudaGetLastError();
}
