// soft_argmax: the decode of 2D keypoint heatmaps, pose2d.soft_argmax, in
// one pass over the logits, for Hopper (sm_90a).
//
// Replaces no TPU kernel: tpubody leaves the decode to XLA.  It was added
// for Sapiens' decode (tpubody_torch/models/sapiens.py, SapiensPose.decode),
// which ran soft_argmax's eager chain: a softmax over the strided pixel axis
// of (B, h w, K) logits, its peak and two expectations, each a pass over
// the probabilities.  At 32 frames of 256 x 192 x 308 that chain took 62.5
// ms a batch, about a hundred times what the bytes need.
//
// It computes, for frame b and keypoint k, over the pixels p = (y, x) of
// float32 logits l (B, H, W, K):
//   m  = max_p l[p]
//   s  = sum_p e[p],  e[p] = exp(l[p] - m)
//   sx = sum_p e[p] x,  sy = sum_p e[p] y
//   out[b, k] = (sx / s * stride + (stride - 1) / 2,
//                sy / s * stride + (stride - 1) / 2,
//                clamp((1 / s) * 8 pi, 0, 1))
// 1 / s is the peak probability, exp(m - m) / s.  Everything is float32 and
// exp is the full-precision expf; the sums are taken in another order than
// the eager chain's, so the answers differ from it in the last bits.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM): bytes.  An element is 4
// bytes read once for about one expf and four other operations; at (32,
// 256, 192, 308) that is 1.94 GB, 0.578 ms.
//
// What the design does about it: the logits are read once, in place, and
// nothing of their size is written.  A block takes one frame and one slice
// of its pixel rows (partial_kernel).  Its threads lie (rows, cols) over the
// pixel rows and the keypoints: cols threads across a row, each on V
// neighbouring keypoints (V = 4 by 16-byte loads where K % 4 == 0 and the
// logits are 16-byte aligned, else V = 1), and `rows` rows a step, so that
// one step of a block reads one contiguous run of memory.  A thread keeps
// kInFlight rows' loads in flight, with the streaming hint (__ldcs: every
// byte is read once), and holds for each of its keypoints the running max
// and the three sums, rescaled by exp(m_old - m_new) when the max grows (an
// online softmax: kInFlight + 1 expf a kInFlight rows).  The `rows` threads
// of a keypoint merge through shared memory in the order r = 0 .. rows - 1,
// and the block writes its partial (m, s, sx, sy) a keypoint; merge_kernel
// merges a frame's slices in their order, each rescaled by exp(m_i - m),
// and writes the answers.  No atomics: one input gives the same bits on
// every run on one card.  The slice count fills the card: B x slices
// blocks are at most one wave of the blocks that fit at once (the occupancy
// query), so 16 frames fill the 132 SMs as 32 do; a slice keeps at least
// one full step of every thread.  K above 2048 (V = 4) or 512 (V = 1) goes
// in passes over the slice, one a group of keypoints.  The kernels run on
// the caller's stream and allocate and synchronise nothing.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;    // at most, a block
constexpr int kInFlight = 4;     // rows a thread loads before it sums
constexpr int kMergeThreads = 256;
constexpr float kEightPi = 25.132741228718345f;   // 2 pi x 4

struct Layout {
  int vec;      // keypoints a thread: 4 or 1
  int groups;   // groups of vec keypoints in a row: K / vec
  int cols;     // threads across a row
  int rows;     // rows a step
  int passes;   // groups of cols x vec keypoints
};

Layout layout_of(int K, int vec) {
  Layout L;
  L.vec = vec ? 4 : 1;
  L.groups = K / L.vec;
  L.cols = L.groups < kThreads ? L.groups : kThreads;
  L.rows = kThreads / L.cols;
  L.passes = (L.groups + L.cols - 1) / L.cols;
  return L;
}

__device__ __forceinline__ void load(float (&v)[4], const float* p) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load(float (&v)[1], const float* p) {
  v[0] = __ldcs(p);
}

// Fold N rows of V keypoints, at pixel columns fx and rows fy, into the
// running (m, s, sx, sy).  The max of a keypoint that has seen only -inf
// stays -inf, and its sums 0.
template <int N, int V>
__device__ __forceinline__ void fold(float (&m)[V], float (&s)[V],
                                     float (&sx)[V], float (&sy)[V],
                                     const float (&l)[N][V],
                                     const float (&fx)[N],
                                     const float (&fy)[N]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float top = m[j];
#pragma unroll
    for (int u = 0; u < N; ++u) top = fmaxf(top, l[u][j]);
    const float ref = top == -INFINITY ? 0.f : top;
    const float a = expf(m[j] - ref);
    float es = 0.f, ex = 0.f, ey = 0.f;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const float e = expf(l[u][j] - ref);
      es += e;
      ex = fmaf(e, fx[u], ex);
      ey = fmaf(e, fy[u], ey);
    }
    s[j] = fmaf(s[j], a, es);
    sx[j] = fmaf(sx[j], a, ex);
    sy[j] = fmaf(sy[j], a, ey);
    m[j] = top;
  }
}

// Step a pixel (x, y) of a W-wide map by dy rows and dx columns, dx < W.
__device__ __forceinline__ void advance(int& x, int& y, int dx, int dy,
                                        int W) {
  x += dx;
  y += dy;
  if (x >= W) {
    x -= W;
    ++y;
  }
}

// Block (b, slice): the partial (m, s, sx, sy) of every keypoint over the
// pixel rows [slice * per, min(P, (slice + 1) * per)) of frame b, into
// part[b][slice][field][k].
template <int V>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ logits,   // (B, P, K)
               float* __restrict__ part,           // (B, slices, 4, K)
               int P, int W, int K, int cols, int rows, int passes,
               int slices, int per) {
  __shared__ float sm[4][kThreads * 4];   // field, (r, keypoint of a pass)
  const int b = blockIdx.x / slices, slice = blockIdx.x % slices;
  const int tc = threadIdx.x % cols, r = threadIdx.x / cols;
  const int groups = K / V, width = cols * V;
  const int p0 = slice * per;
  const int p1 = min(P, p0 + per);
  const int dy = rows / W, dx = rows % W;
  const float* frame = logits + (size_t)b * P * K;
  float* out = part + ((size_t)b * slices + slice) * 4 * K;
  for (int pass = 0; pass < passes; ++pass) {
    const int c = pass * cols + tc;
    float m[V], s[V], sx[V], sy[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = -INFINITY;
      s[j] = sx[j] = sy[j] = 0.f;
    }
    if (c < groups) {
      const float* col = frame + (size_t)c * V;
      int p = p0 + r, x = p % W, y = p / W;
      for (; p + (kInFlight - 1) * rows < p1; p += kInFlight * rows) {
        float l[kInFlight][V], fx[kInFlight], fy[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          load(l[u], col + (size_t)(p + u * rows) * K);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          fx[u] = (float)x;
          fy[u] = (float)y;
          advance(x, y, dx, dy, W);
        }
        fold<kInFlight, V>(m, s, sx, sy, l, fx, fy);
      }
      for (; p < p1; p += rows) {
        float l[1][V];
        load(l[0], col + (size_t)p * K);
        const float fx[1] = {(float)x}, fy[1] = {(float)y};
        fold<1, V>(m, s, sx, sy, l, fx, fy);
        advance(x, y, dx, dy, W);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int at = r * width + tc * V + j;
      sm[0][at] = m[j];
      sm[1][at] = s[j];
      sm[2][at] = sx[j];
      sm[3][at] = sy[j];
    }
    __syncthreads();
    for (int kc = threadIdx.x; kc < width; kc += blockDim.x) {
      const int k = pass * width + kc;
      if (k >= K) break;
      float top = -INFINITY;
      for (int i = 0; i < rows; ++i) top = fmaxf(top, sm[0][i * width + kc]);
      const float ref = top == -INFINITY ? 0.f : top;
      float ts = 0.f, tx = 0.f, ty = 0.f;
      for (int i = 0; i < rows; ++i) {
        const int at = i * width + kc;
        const float a = expf(sm[0][at] - ref);
        ts = fmaf(sm[1][at], a, ts);
        tx = fmaf(sm[2][at], a, tx);
        ty = fmaf(sm[3][at], a, ty);
      }
      out[k] = top;
      out[K + k] = ts;
      out[2 * K + k] = tx;
      out[3 * K + k] = ty;
    }
    __syncthreads();
  }
}

// Thread (b, k): frame b's slices merged in their order -> out[b][k] =
// (x, y, confidence).
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part, float* __restrict__ out,
             int B, int K, int slices, float stride) {
  const long long i = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= (long long)B * K) return;
  const int b = (int)(i / K), k = (int)(i % K);
  const float* q = part + (size_t)b * slices * 4 * K + k;
  float top = -INFINITY;
  for (int j = 0; j < slices; ++j) top = fmaxf(top, q[(size_t)j * 4 * K]);
  const float ref = top == -INFINITY ? 0.f : top;
  float s = 0.f, sx = 0.f, sy = 0.f;
  for (int j = 0; j < slices; ++j) {
    const float* e = q + (size_t)j * 4 * K;
    const float a = expf(e[0] - ref);
    s = fmaf(e[K], a, s);
    sx = fmaf(e[2 * K], a, sx);
    sy = fmaf(e[3 * K], a, sy);
  }
  const float half = 0.5f * (stride - 1.f);
  const float conf = (1.f / s) * kEightPi;
  out[3 * i] = sx / s * stride + half;
  out[3 * i + 1] = sy / s * stride + half;
  // NaN passes through, as torch.clamp's does.
  out[3 * i + 2] = conf < 0.f ? 0.f : (conf > 1.f ? 1.f : conf);
}

bool valid(int B, int H, int W, int K, int vec) {
  return B >= 0 && H >= 1 && W >= 1 && K >= 1 &&
         (long long)H * W <= INT_MAX && (!vec || K % 4 == 0);
}

}  // namespace

// The slice count of a call of tpubody_soft_argmax on B frames of H x W
// pixels of K keypoints (vec: 16-byte loads, K % 4 == 0) on the current
// device: the most that keeps B x slices blocks within one wave of the
// blocks that fit at once and every slice at least one full step of rows,
// at least 1.  Writes it to *slices; returns a CUDA error code.
extern "C" int tpubody_soft_argmax_slices(int B, int H, int W, int K,
                                          int vec, int* slices) {
  if (!valid(B, H, W, K, vec)) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(K, vec);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, L.vec == 4 ? partial_kernel<4> : partial_kernel<1>,
        L.cols * L.rows, 0);
  if (err != cudaSuccess) return (int)err;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long fill = B > 0 ? wave / B : wave;
  const long long steps = (long long)H * W / ((long long)kInFlight * L.rows);
  long long n = fill < steps ? fill : steps;
  *slices = (int)(n > 1 ? n : 1);
  return (int)cudaSuccess;
}

// logits (B, H, W, K) float32, row-major (16-byte aligned if vec); part
// (B, slices, 4, K) float32 scratch; out (B, K, 3) float32.  slices from
// tpubody_soft_argmax_slices (any value from 1 to H x W gives the same
// answers up to the order of the sums).  Two launches on `stream`,
// partial_kernel then merge_kernel; returns cudaGetLastError() after them.
extern "C" int tpubody_soft_argmax(const float* logits, float* part,
                                   float* out, int B, int H, int W, int K,
                                   int vec, int slices, float stride,
                                   cudaStream_t stream) {
  const long long P = (long long)H * W;
  if (!valid(B, H, W, K, vec) || slices < 1 || slices > P ||
      (long long)B * slices > INT_MAX ||
      (vec && reinterpret_cast<uintptr_t>(logits) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Layout L = layout_of(K, vec);
  const int per = (int)((P + slices - 1) / slices);
  const unsigned blocks = (unsigned)((long long)B * slices);
  if (L.vec == 4)
    partial_kernel<4><<<blocks, L.cols * L.rows, 0, stream>>>(
        logits, part, (int)P, W, K, L.cols, L.rows, L.passes, slices, per);
  else
    partial_kernel<1><<<blocks, L.cols * L.rows, 0, stream>>>(
        logits, part, (int)P, W, K, L.cols, L.rows, L.passes, slices, per);
  const long long n = (long long)B * K;
  merge_kernel<<<(unsigned)((n + kMergeThreads - 1) / kMergeThreads),
                 kMergeThreads, 0, stream>>>(part, out, B, K, slices,
                                             stride);
  return (int)cudaGetLastError();
}
