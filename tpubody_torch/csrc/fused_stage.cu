// fused_stage: one stride-1 ResNet bottleneck (1x1 -> 3x3 -> 1x1, BatchNorm
// folded, residual add, relus) in one kernel, on Hopper's warpgroup tensor
// cores (sm_90a): wgmma with the weights in shared memory, filled by a
// producer warp through an mbarrier ring.  A chain of bottlenecks is one
// launch a block; between blocks the bf16 activation goes through device
// memory, which changes no bit, because a block's output is rounded to
// bf16 anyway.
//
// Replaces: tpubody/models/pallas_resnet.py::_stage_kernel (the Pallas TPU
// kernel behind run_stage).  It computes the same function.  Like the TPU
// kernel, it works on the flattened, zero-padded image: pixel (y, x) of
// image b sits at position s = (1 + b (H + 1) + y) (W + 2) + x + 1 of one
// sequence that runs over the whole batch (each image's rows are (W + 2)
// wide, with one zero row between images), so a 3x3 tap is the constant
// offset (dy - 1)(W + 2) + dx - 1, as the TPU kernel's rolls are.  A block
// owns a band of kM = 256 consecutive positions: only the two pad columns
// of each row and the pad row of each image are wasted (1.11x the pixels
// at 28^2, 1.05x at 56^2, where 8x16 tiles would cover 1.31x at 28^2), and a
// band may span two images.
//
// Inputs (tpubody_torch/models/fused_resnet.py packs the weights once, at
// fuse_stage time; Xp = X rounded up to a multiple of 64, zero filled):
//   x  (B, H, W, Cin) bf16, NHWC, contiguous, 16-byte aligned, Cin % 8 == 0
//   w1 Cin_p / 64 tiles of (Cmid_p rows, 64) bf16 [k slice]
//   w2 9 x Cmid_p / 64 tiles of (Cmid_p, 64)      [tap (dy * 3 + dx)][k slice]
//   w3 tiles of (128 rows, or the rest, 64)      [128-channel chunk][k slice]
//   wd as w3 over Cin_p, or null for an identity residual (Cin == Cout)
//   b1, b2 (Cmid_p), b3, bd (Cout_p) f32
// Each tile is the exact image one wgmma B descriptor reads (K-major, 128
// bytes a row, 128-byte swizzle: the 16-byte chunk c of row n lands at
// chunk c ^ (n & 7)), so one cp.async.bulk lands it ready to use: no
// tensor map, no libcuda call.  Output: y (B, H, W, Cout) bf16, Cout % 8 == 0
// (the wrapper pads x's channel axis with zeros to a multiple of 8 and
// slices y).
//
// Two routes, chosen by Cmid_p and instantiated by template, so that the
// narrow one compiles to the same code whatever the wide one does:
//   narrow (Cmid_p <= 128: ResNet-50's stages 1 and 2), kFull: one launch a
//     bottleneck, bands of kM = 256 positions, h1 and h2 in shared memory;
//   wide (Cmid_p > 128: stages 3 and 4, 256 and 512), bands of kM = 128
//     (one m64 row tile a consumer warpgroup), conv1 and conv2 in column
//     passes of at most 128 output channels (the accumulators of one pass
//     are those of the narrow route).  h1 over a band and its halo at
//     C_mid 512 and a band of 256 would be 320 x 520 x 2 bytes, and h2
//     another 266 KB: more than a block's 227 KB.  Where a band of 128
//     holds both (C_mid 256 at 14^2, identity: 219,760 bytes), kFull runs
//     the bottleneck in one launch; elsewhere (C_mid 512, or a downsample)
//     it takes two: kFront keeps h1 (its rows rounded to 8, not 64) in
//     shared memory and writes h2 to a scratch buffer in device memory
//     (B H W, Cmid_p) bf16; kBack runs conv3 (+ the downsample) with its A
//     read from that buffer through the x ring, moving 2 x 2 Cmid_p bytes
//     a pixel more.  With one row tile a warpgroup, the other accumulators
//     hold each K slice's products fresh, added to the running sums in f32
//     (see mma_round): the long sums of the wide widths stay rounded.  h2
//     is rounded to bf16 on every route, so all give the same bits.
//
// Arithmetic, which decides the bits: operands bf16, every product summed
// in f32 (wgmma m64n64k16, bf16 in, f32 out), bias added in f32, relu, h1,
// h2 and y rounded to bf16 to nearest even.  h1 at positions outside the
// image is written as ZERO: conv2's padding pads h1, and h1 of a zero input
// would be relu(b1), not 0.  The residual of a widening block is wd . x +
// bd in f32, unrounded, accumulated with w3 . h2; the residual of an
// identity block is the bf16 x widened.  The order of the f32 sums differs
// from the plain PyTorch version's, so the two differ where a sum lands
// within an f32 rounding of a bf16 boundary: a tolerance, not equality.
//
// What bounds it on an H100 SXM (data sheet: 989 TFLOP/s dense bf16,
// 3.35 TB/s): a bottleneck at 64 -> 256 channels does 139,264 to 147,456
// operations a pixel for 640 bytes read and written, about 220 a byte, and
// at 512 -> 128 -> 512 channels 557,056 for 2,048 bytes (272 a byte): both
// near the ridge (295), bound by operations once conv1's recomputation on
// the band's halo (2 (W + 2) + 2 positions) is added.
//
// What the design does about it.  384 threads: warpgroup 0 is the
// producer (setmaxnreg gives its registers to the consumers), warpgroups 1
// and 2 are the consumers, 128 band positions each (two m64 row tiles).
// Every product is wgmma.mma_async m64n64k16 with B (a 64-channel K slice
// of the weights, 64 or 128 output channels) from a shared-memory
// descriptor and A from registers, loaded by ldmatrix from shared memory:
// a 3x3 tap is a row offset that is not aligned to the 8-row core matrices
// of an A descriptor, and ldmatrix takes one address per row, so the nine
// taps cost nothing extra; conv1, conv3 and the downsample read A the same
// way (one code path; x rows are swizzled as the weights are, so ldmatrix
// is free of bank conflicts).  A round is one K slice: one wgmma group a
// k step of 16, the next step's A fragments loaded while the current one
// multiplies.  The K slices move through two mbarrier rings: weights (2
// to 4 stages, one bulk copy each by one producer thread, complete_tx) and x
// (kSX stages of 256 rows, cp.async by the 128 producer threads, zero-
// filled outside the image and past Cin, each thread arriving with
// cp.async.mbarrier.arrive).  Consumers wait on "full" and release
// "empty": no block-wide barrier a slice.  h1 (the band and its halo) and
// h2 never leave shared memory; a named barrier over the 256 consumer
// threads orders them.  Each weight slice serves 256 output positions,
// twice what a 128-pixel tile would, so the weights are read from L2 half
// as often.  The last
// epilogue goes through shared memory (over h1, dead by then), so that the
// residual comes in and y goes out in 16-byte pieces.  One block an SM
// (about 220 KB of shared memory at the widths above).
//
// The wrapper allocates the output; the kernel runs on the caller's
// stream, allocates nothing, synchronises nothing, and the entry point
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;           // producer warpgroup + 2 consumers
constexpr int kConsumers = 256;
// Weight ring stages: the most of 4, 3, 2 that the shared memory holds
// (4 at 256 -> 64 -> 256 without a downsample, 2 at the other widths of
// ResNet-50's stages 1 and 2).
constexpr int kSWMax = 4, kSWMin = 2;
constexpr int kSXMax = 3;               // x ring stages (barriers for)
constexpr int kWBytes = 128 * 128;      // weight slice: <= 128 rows x 128 B
constexpr int kMaxSmem = 232448;        // 227 KB a block
constexpr int kLdo = 72;                // epilogue staging row, bf16

// The routes (see the head of the file).
constexpr int kFull = 0, kFront = 1, kBack = 2;

template <int kM, int kMode>
struct Route {
  static constexpr int kRT = kM / 128;            // m64 row tiles a warpgroup
  static constexpr int kSX = kMode == kFront ? 2 : kSXMax;
  static constexpr int kXBytes = kM * 128;        // x slice: kM rows x 128 B
};

__host__ __device__ inline int round64(int c) { return (c + 63) & ~63; }

// Shared memory of one block, bytes from a 1024-aligned base: the two
// rings, then
//   kFull:  h1 over the band and its halo, h2 (over the x ring when there
//           is no downsample: x is then read by conv1 only);
//   kFront: h1 only, its rows rounded up to 8 (conv1's last row tile stores
//           only the rows that exist);
//   kBack:  the last epilogue's staging tile (in h1's place);
// then the barriers and the pixel of each band row.
struct Layout {
  int sw, h1_rows, ldh, x_off, h1_off, h2_off, bar_off, pix_off, bytes;
};

template <int kM, int kMode>
__host__ __device__ inline Layout layout_sw(int W, int cmid_p, bool down,
                                            int sw) {
  typedef Route<kM, kMode> R;
  Layout L;
  L.sw = sw;
  L.h1_rows = kMode == kFront ? (kM + 2 * (W + 2) + 2 + 7) & ~7
                              : (kM + 2 * (W + 2) + 2 + 63) & ~63;
  L.ldh = cmid_p + 8;                   // row stride (bf16) of h1 and h2
  const int h2_bytes = kMode == kFull ? kM * L.ldh * 2 : 0;
  const int ring_x = R::kSX * R::kXBytes;
  L.x_off = sw * kWBytes;
  int end = L.x_off + ring_x;
  if (down || kMode != kFull) {
    L.h2_off = end;
    end += h2_bytes;
  } else {
    L.h2_off = L.x_off;
    end = L.x_off + (h2_bytes > ring_x ? h2_bytes : ring_x);
  }
  L.h1_off = end;
  end += kMode == kBack ? kM * kLdo * 2 : L.h1_rows * L.ldh * 2;
  L.bar_off = (end + 7) & ~7;
  L.pix_off = L.bar_off + 2 * (kSWMax + kSXMax) * 8;  // kM ints
  L.bytes = L.pix_off + kM * 4 + 1024;                // + base alignment
  return L;
}

template <int kM, int kMode>
__host__ __device__ inline Layout layout(int W, int cmid_p, bool down) {
  Layout L = layout_sw<kM, kMode>(W, cmid_p, down, kSWMax);
  for (int sw = kSWMax - 1; sw >= kSWMin && L.bytes > kMaxSmem; --sw)
    L = layout_sw<kM, kMode>(W, cmid_p, down, sw);
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// Spins until the phase of parity `phase` has completed.  A wait that
// outlasts some seconds means a broken schedule: trap (the launch then
// fails with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One contiguous global -> shared copy, completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared; zeros where `pred` is false (nothing read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// ---- warpgroup products
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Descriptor of a K-major B tile with 128-byte rows and 128-byte swizzle:
// start address >> 4, leading offset unused (1), stride 1024 bytes between
// groups of 8 rows, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// d (64 x 64, f32, this thread's 32) = d * accumulate + a (64 x 16, bf16,
// from registers: this warp's 16 rows as an mma.m16n8k16 A fragment) . B
// (from `desc`).
__device__ __forceinline__ void wgmma_64x64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc,
                                            int accumulate = 1) {
  // scale-d = accumulate, scale-a = scale-b = 1, B not transposed
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Position s of the padded sequence -> pixel index b * H * W + y * W + x,
// or -1 for a pad position or one past the batch.
__device__ __forceinline__ int pixel_at(int s, int B, int H, int W) {
  const int Wp = W + 2;
  if (s < Wp) return -1;
  const int r = s / Wp - 1;
  const int xp = s - (r + 1) * Wp;
  const int b = r / (H + 1);
  const int y = r - b * (H + 1);
  if (b >= B || y >= H || xp < 1 || xp > W) return -1;
  return (b * H + y) * W + xp - 1;
}

// Keep registers in place across an asynchronous wgmma: the compiler may
// neither move nor reuse them before the wait that follows.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

template <int kM, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                  bf16* __restrict__ h2g,
                  const bf16* __restrict__ w1, const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ b2,
                  const bf16* __restrict__ w3, const float* __restrict__ b3,
                  const bf16* __restrict__ wd, const float* __restrict__ bd,
                  int B, int H, int W, int Cin, int Cmid_p, int Cout) {
  typedef Route<kM, kMode> R;
  constexpr int kSX = R::kSX, kXBytes = R::kXBytes, kRT = R::kRT;
  constexpr int kAllTiles = kRT == 2 ? 3 : 1;   // mask of every row tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const bool down = wd != nullptr;
  const Layout L = layout<kM, kMode>(W, Cmid_p, down);
  const int Wp = W + 2;
  const int Cin_p = round64(Cin), Cout_p = round64(Cout);
  const int ks_in = Cin_p / 64, ks_mid = Cmid_p / 64;
  const int passes = (L.h1_rows + kM - 1) / kM;
  const int nchunks = (Cout_p + 127) / 128;
  // column passes of conv1 and conv2 (one on the narrow route: two row
  // tiles a warpgroup, C_mid <= 128)
  const int ncols = kRT == 2 ? 1 : (Cmid_p + 127) / 128;
  const int s0 = Wp + blockIdx.x * kM;          // band row 0
  const int h0 = s0 - Wp - 1;                   // h1 row 0 (tap 0, 0)
  const uint32_t wring = smem_u32(base), xring = wring + L.x_off;
  const uint32_t sH1 = wring + L.h1_off, sH2 = wring + L.h2_off;
  bf16* pH1 = reinterpret_cast<bf16*>(base + L.h1_off);
  bf16* pH2 = reinterpret_cast<bf16*>(base + L.h2_off);
  const uint32_t bars = wring + L.bar_off;
  const int sw = L.sw;
  auto full_w = [&](int i) { return bars + 8 * i; };
  auto empty_w = [&](int i) { return bars + 8 * (kSWMax + i); };
  auto full_x = [&](int i) { return bars + 8 * (2 * kSWMax + i); };
  auto empty_x = [&](int i) { return bars + 8 * (2 * kSWMax + kSX + i); };
  // output channels of column pass nc of conv1 / conv2 (a chunk of w1, w2)
  auto col_rows = [&](int nc) { return min(128, Cmid_p - nc * 128); };
  if (threadIdx.x == 0) {
    for (int i = 0; i < sw; ++i) {
      mbar_init(full_w(i), 1);                   // the expect_tx arrival
      mbar_init(empty_w(i), kConsumers / 32);    // every consumer warp
    }
    for (int i = 0; i < kSX; ++i) {
      mbar_init(full_x(i), 128);                 // every producer thread
      mbar_init(empty_x(i), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ================= producer: copies in the order the consumers take
    // them: conv1 over the band and its halo in passes of kM rows (K slices
    // of Cin_p), conv2 over the 9 taps (K slices of Cmid_p), each in column
    // passes of up to 128 output channels; conv3 (+ the downsample) per
    // chunk of up to 128 output channels, its A from h2 in shared memory
    // (kFull) or from the scratch buffer through the x ring (kBack).
    // Thread 0 starts the weights' bulk copies; the 128 threads the x
    // slices, kM / 128 rows each.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int pt = threadIdx.x;
    int ws = 0, wph = 0, xs = 0, xph = 0;
    auto put_w = [&](const bf16* src, int rows) {
      if (pt == 0) {
        mbar_wait(empty_w(ws), wph ^ 1);
        mbar_expect_tx(full_w(ws), rows * 128);
        bulk_copy(wring + ws * kWBytes, src, rows * 128, full_w(ws));
      }
      if (++ws == sw) { ws = 0; wph ^= 1; }
    };
    // rows [0, nrows) of an x slice <- channels [64 ks, 64 ks + 64) of the
    // pixels at positions s_first.. of src (C channels a pixel), zero
    // outside the image and past C; 128-byte rows, chunk c of row r at
    // chunk c ^ (r & 7)
    auto put_x = [&](const bf16* src, int C, int s_first, int nrows,
                     int ks) {
      mbar_wait(empty_x(xs), xph ^ 1);
      const uint32_t buf = xring + xs * kXBytes;
      for (int r = pt; r < kM; r += 128) {
        const int pix = r < nrows ? pixel_at(s_first + r, B, H, W) : -1;
        const bf16* row = src + (size_t)(pix < 0 ? 0 : pix) * C;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int k = ks * 64 + c * 8;
          const bool in = pix >= 0 && k < C;
          cp_async16(buf + r * 128 + ((c ^ (r & 7)) << 4), in ? row + k : src,
                     in);
        }
      }
      cp_async_arrive(full_x(xs));
      if (++xs == kSX) { xs = 0; xph ^= 1; }
    };
    if constexpr (kMode != kBack) {
      for (int nc = 0; nc < ncols; ++nc)
        for (int p = 0; p < passes; ++p)
          for (int ks = 0; ks < ks_in; ++ks) {
            put_w(w1 + ((size_t)nc * ks_in * 128 + ks * col_rows(nc)) * 64,
                  col_rows(nc));
            put_x(x, Cin, h0 + p * kM, L.h1_rows - p * kM, ks);
          }
      for (int nc = 0; nc < ncols; ++nc)
        for (int tap = 0; tap < 9; ++tap)
          for (int ks = 0; ks < ks_mid; ++ks)
            put_w(w2 + (size_t)tap * Cmid_p * Cmid_p +
                      ((size_t)nc * ks_mid * 128 + ks * col_rows(nc)) * 64,
                  col_rows(nc));
    }
    if constexpr (kMode != kFront) {
      for (int nc = 0; nc < nchunks; ++nc) {
        const int rows = min(128, Cout_p - nc * 128);
        for (int ks = 0; ks < ks_mid; ++ks) {
          put_w(w3 + ((size_t)nc * ks_mid * 128 + ks * rows) * 64, rows);
          if constexpr (kMode == kBack) put_x(h2g, Cmid_p, s0, kM, ks);
        }
        if (down)
          for (int ks = 0; ks < ks_in; ++ks) {
            put_w(wd + ((size_t)nc * ks_in * 128 + ks * rows) * 64, rows);
            put_x(x, Cin, s0, kM, ks);
          }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // =================== consumers: warpgroup c owns band rows kM / 2 c ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int c = (threadIdx.x >> 7) - 1;
  const int wq = (threadIdx.x >> 5) & 3;        // warp in the warpgroup
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 15;                   // ldmatrix: row this lane
  const int lchunk = lane >> 4;                 // names, 16-byte chunk
  const int r0 = c * (kM / 2) + wq * 16;        // + i * 64: this warp's rows
  const int ldh = L.ldh;
  int ws = 0, wph = 0, xs = 0, xph = 0;
  float acc[2][2][32];
  // pixel of each band row (-1: pad or past the batch), read by the
  // epilogues of conv2 (kFront) and conv3; complete at the consumer barrier
  // after conv1 (kBack: the one before conv3)
  int* rowpix = reinterpret_cast<int*>(base + L.pix_off);
  if (kM == kConsumers || threadIdx.x - 128 < kM)
    rowpix[threadIdx.x - 128] = pixel_at(s0 + threadIdx.x - 128, B, H, W);
  const int ct = threadIdx.x & 127;             // thread in the warpgroup

  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][n][e] = 0.0f;
  };
  auto pin_acc = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 32; ++e) pin(acc[i][n][e]);
  };
  // One round: wait for the weight slice and multiply it into the row
  // tiles of TILES (bit i: accumulators acc[i]), NT 64-channel column
  // tiles, A from a_addr(i, kk) (this lane's ldmatrix address for tile i
  // at k step kk).  One
  // wgmma group a k step; the A fragments of step kk + 1 are loaded while
  // step kk multiplies (two register buffers; a buffer is refilled once
  // the group that read it is done).  Then the slice is released.
  // On the wide route (one row tile a warpgroup) the round's products go
  // into the spare accumulators acc[1], fresh each round, and are then
  // added to acc[0] by a rounded f32 add: the tensor cores' own
  // accumulation over K = 2,304 or 4,608 (conv2 at C_mid 256, 512) drifts
  // from a rounded sum far enough to move a bf16 rounding of h1, h2 or y
  // on more than 1% of a block's outputs (PERF.md), and 64 products
  // a round keep it short.
  constexpr bool kPromote = kRT == 1;
  auto mma_round = [&](auto a_addr, auto tiles_c, auto nt_c) {
    constexpr int kTiles = kPromote ? decltype(tiles_c)::value & 1
                                    : decltype(tiles_c)::value;
    constexpr int kNT = decltype(nt_c)::value;
    mbar_wait(full_w(ws), wph);
    const uint32_t wb = wring + ws * kWBytes;
    uint32_t a[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (kTiles >> i & 1) ldmatrix_x4(a[0][i], a_addr(i, 0));
    pin_acc();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          if (kTiles >> i & 1)
            wgmma_64x64(acc[kPromote ? 1 : i][n], a[kk & 1][i],
                        desc_b(wb + n * 8192 + kk * 32),
                        kPromote ? kk > 0 : 1);
      wgmma_commit();
      if (kk < 3) {
        wgmma_wait<1>();                // step kk - 1 is done with its A
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) pin(a[(kk + 1) & 1][i][q]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (kTiles >> i & 1) ldmatrix_x4(a[(kk + 1) & 1][i], a_addr(i, kk + 1));
      }
    }
    wgmma_wait<0>();
    pin_acc();
    if constexpr (kPromote && (kTiles & 1))
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[0][n][e] += acc[1][n][e];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) pin(a[b][i][q]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_w(ws));
    if (++ws == sw) { ws = 0; wph ^= 1; }
  };
  auto take_x = [&]() {
    mbar_wait(full_x(xs), xph);
    return xring + xs * kXBytes;
  };
  auto release_x = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_x(xs));
    if (++xs == kSX) { xs = 0; xph ^= 1; }
  };
  // ldmatrix address into a swizzled x slice / a plain h1 or h2 row
  auto x_addr = [&](uint32_t buf, int r, int kk) {
    return buf + r * 128 + (((kk * 2 + lchunk) ^ (r & 7)) << 4);
  };
  auto h_addr = [&](uint32_t h, int r, int col) {
    return h + (r * ldh + col) * 2;
  };

  // ---- conv1 on the band and its halo, output channels 128 nc ..:
  // h1 = bf16(relu(w1 . x + b1)), 0 at positions outside the image.  A pass
  // covers up to 2 kRT row tiles of 64; tile j goes to warpgroup j % 2, so
  // that a short last pass is shared by both.
  const int c1 = c * 64 + wq * 16;              // + 128 i: this warp's rows
  auto conv1 = [&](int nc, auto nt_c) {
    constexpr int kNT = decltype(nt_c)::value;
    for (int p = 0; p < passes; ++p) {
      int tiles = 0;
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        if (p * kM + c * 64 + i * 128 < L.h1_rows) tiles |= 1 << i;
      zero();
      for (int ks = 0; ks < ks_in; ++ks) {
        const uint32_t xb = take_x();
        auto addr = [&](int i, int kk) {
          return x_addr(xb, c1 + i * 128 + lrow, kk);
        };
        if (tiles == 3) mma_round(addr, Int<3>{}, nt_c);
        else if (tiles == 1) mma_round(addr, Int<1>{}, nt_c);
        else mma_round(addr, Int<0>{}, nt_c);   // keeps the ring turning
        release_x();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!(tiles >> i & 1)) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int hl = p * kM + c1 + i * 128 + g + 8 * h;
          if (kMode == kFront && hl >= L.h1_rows) continue;
          const bool inside = pixel_at(h0 + hl, B, H, W) >= 0;
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int ch = nc * 128 + n * 64 + j * 8 + 2 * t;
              float v0 = 0.0f, v1 = 0.0f;
              if (inside) {
                v0 = fmaxf(acc[i][n][j * 4 + 2 * h] + b1[ch], 0.0f);
                v1 = fmaxf(acc[i][n][j * 4 + 2 * h + 1] + b1[ch + 1], 0.0f);
              }
              *reinterpret_cast<__nv_bfloat162*>(pH1 + hl * ldh + ch) =
                  __floats2bfloat162_rn(v0, v1);
            }
        }
      }
    }
  };

  // ---- conv2, 3x3 over h1, output channels 128 nc ..: tap (dy, dx) is row
  // offset dy * Wp + dx; h2 = bf16(relu(. + b2)) into shared memory
  // (kFull) or the scratch buffer at the band row's pixel (kFront)
  auto conv2 = [&](int nc, auto nt_c) {
    constexpr int kNT = decltype(nt_c)::value;
    zero();
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * Wp + tap % 3;
      for (int ks = 0; ks < ks_mid; ++ks)
        mma_round([&](int i, int kk) {
                    return h_addr(sH1, r0 + i * 64 + lrow + off,
                                  ks * 64 + kk * 16 + lchunk * 8);
                  },
                  Int<kAllTiles>{}, nt_c);
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + i * 64 + g + 8 * h;
        bf16* out = pH2 + m * ldh;
        if constexpr (kMode == kFront) {
          const int px = rowpix[m];
          if (px < 0) continue;
          out = h2g + (size_t)px * Cmid_p;
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ch = nc * 128 + n * 64 + j * 8 + 2 * t;
            const float v0 = fmaxf(acc[i][n][j * 4 + 2 * h] + b2[ch], 0.0f);
            const float v1 = fmaxf(acc[i][n][j * 4 + 2 * h + 1] + b2[ch + 1],
                                   0.0f);
            *reinterpret_cast<__nv_bfloat162*>(out + ch) =
                __floats2bfloat162_rn(v0, v1);
          }
      }
  };

  // ---- conv3 (+ downsample) + residual for the output channels of chunk
  // nc: y = bf16(relu(. + b3 + res)).  The epilogue goes through shared
  // memory (h1 is dead by then), 64 channels at a time, each warpgroup
  // over its own 128 rows: the residual tile comes in (cp.async; the first
  // one while the chunk's products run), every thread adds its sums in f32
  // and rounds in place, the tile goes out; residual and y move in 16-byte
  // pieces, a pixel's 64 channels side by side.
  constexpr int kRows = kM / 2;                 // band rows a warpgroup
  bf16* stage = pH1 + c * kRows * kLdo;
  auto wg_sync = [&]() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  };
  auto fetch_residual = [&](int ch0) {        // identity blocks: Cin == Cout
    for (int u = ct; u < kRows * 8; u += 128) {
      const int row = u >> 3, c8 = (u & 7) * 8;
      const int px = rowpix[c * kRows + row];
      const bool in = px >= 0 && ch0 + c8 < Cout;
      cp_async16(smem_u32(stage + row * kLdo + c8),
                 in ? x + (size_t)px * Cin + ch0 + c8 : x, in);
    }
    cp_async_commit();
  };
  auto conv3 = [&](int nc, auto nt_c) {
    constexpr int kNT = decltype(nt_c)::value;
    if (!down) fetch_residual(nc * 128);
    zero();
    for (int ks = 0; ks < ks_mid; ++ks) {
      if constexpr (kMode == kBack) {
        const uint32_t hb = take_x();
        mma_round([&](int i, int kk) {
                    return x_addr(hb, r0 + i * 64 + lrow, kk);
                  },
                  Int<kAllTiles>{}, nt_c);
        release_x();
      } else {
        mma_round([&](int i, int kk) {
                    return h_addr(sH2, r0 + i * 64 + lrow,
                                  ks * 64 + kk * 16 + lchunk * 8);
                  },
                  Int<kAllTiles>{}, nt_c);
      }
    }
    if (down)
      for (int ks = 0; ks < ks_in; ++ks) {
        const uint32_t xb = take_x();
        mma_round([&](int i, int kk) {
                    return x_addr(xb, r0 + i * 64 + lrow, kk);
                  },
                  Int<kAllTiles>{}, nt_c);
        release_x();
      }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int ch0 = nc * 128 + n * 64;
      if (!down) {
        if (n > 0) fetch_residual(ch0);
        cp_async_wait_all();
        wg_sync();
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = i * 64 + wq * 16 + g + 8 * h;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = j * 8 + 2 * t;
            __nv_bfloat162* cell =
                reinterpret_cast<__nv_bfloat162*>(stage + row * kLdo + col);
            float v0 = acc[i][n][j * 4 + 2 * h] + b3[ch0 + col];
            float v1 = acc[i][n][j * 4 + 2 * h + 1] + b3[ch0 + col + 1];
            if (down) {
              v0 += bd[ch0 + col];
              v1 += bd[ch0 + col + 1];
            } else {
              const float2 r = __bfloat1622float2(*cell);
              v0 += r.x;
              v1 += r.y;
            }
            *cell = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
        }
      wg_sync();
      for (int u = ct; u < kRows * 8; u += 128) {
        const int row = u >> 3, c8 = (u & 7) * 8;
        const int px = rowpix[c * kRows + row];
        if (px >= 0 && ch0 + c8 < Cout)
          *reinterpret_cast<uint4*>(y + (size_t)px * Cout + ch0 + c8) =
              *reinterpret_cast<const uint4*>(stage + row * kLdo + c8);
      }
      wg_sync();                                // the tile may be refilled
    }
  };

  if constexpr (kMode != kBack) {
    for (int nc = 0; nc < ncols; ++nc) {
      if (col_rows(nc) == 128) conv1(nc, Int<2>{}); else conv1(nc, Int<1>{});
    }
    consumer_sync();                            // h1 complete
    for (int nc = 0; nc < ncols; ++nc) {
      if (col_rows(nc) == 128) conv2(nc, Int<2>{}); else conv2(nc, Int<1>{});
    }
  }
  // h2 complete (kFull); rowpix complete (kBack, which has no conv1 whose
  // barrier would order it)
  if constexpr (kMode != kFront) consumer_sync();
  if constexpr (kMode != kFront) {
    for (int nc = 0; nc < nchunks; ++nc) {
      if (Cout_p - nc * 128 >= 128) conv3(nc, Int<2>{}); else conv3(nc, Int<1>{});
    }
  }
}

// Sets the block's shared memory and launches one route over one block per
// band of kM positions; -> cudaError_t.
template <int kM, int kMode>
int launch(const void* x, void* y, void* h2, const void* w1, const float* b1,
           const void* w2, const float* b2, const void* w3, const float* b3,
           const void* wd, const float* bd, int B, int H, int W, int Cin,
           int cmid_p, int Cout, long long positions, cudaStream_t stream) {
  const Layout L = layout<kM, kMode>(W, cmid_p, wd != nullptr);
  if (L.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<kM, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((positions + kM - 1) / kM);
  bottleneck_kernel<kM, kMode><<<blocks, kThreads, L.bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y),
      static_cast<bf16*>(h2), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(w3), b3,
      static_cast<const bf16*>(wd), bd, B, H, W, Cin, cmid_p, Cout);
  return (int)cudaGetLastError();
}

// The wide route in one launch (kFull on bands of 128) where a block holds
// h1 and h2 of a band (C_mid 256 at 14^2 without a downsample: 219,760
// bytes), else in two.
inline bool wide_in_one(int W, int cmid_p, bool down) {
  return layout<128, kFull>(W, cmid_p, down).bytes <= kMaxSmem;
}

}  // namespace

// Bytes of dynamic shared memory a block needs at these widths (the larger
// of the wide route's two launches where it takes two); the wrapper refuses
// widths that need more than a block can have (232,448).
extern "C" int tpubody_fused_stage_smem_bytes(int W, int Cmid, int has_down) {
  const int cmid_p = round64(Cmid);
  const bool down = has_down != 0;
  if (cmid_p <= 128) return layout<256, kFull>(W, cmid_p, down).bytes;
  if (wide_in_one(W, cmid_p, down))
    return layout<128, kFull>(W, cmid_p, down).bytes;
  const int front = layout<128, kFront>(W, cmid_p, down).bytes;
  const int back = layout<128, kBack>(W, cmid_p, down).bytes;
  return front > back ? front : back;
}

// Kernel launches one bottleneck takes at these widths: 1 (narrow, or wide
// in one), 2 (wide in two, h2 through device memory).
extern "C" int tpubody_fused_stage_launches(int W, int Cmid, int has_down) {
  const int cmid_p = round64(Cmid);
  return cmid_p <= 128 || wide_in_one(W, cmid_p, has_down != 0) ? 1 : 2;
}

// One bottleneck: launches the kernel(s) on `stream` and returns the first
// error (cudaGetLastError() after each launch).  Weights and biases are
// packed as described above (Cmid is the unpadded width); wd and bd are
// null for an identity residual; h2 is a (B H W, round64(Cmid)) bf16
// scratch buffer where the bottleneck takes two launches (may be null
// otherwise).
extern "C" int tpubody_fused_stage_block(
    const void* x, void* y, void* h2, const void* w1, const float* b1,
    const void* w2, const float* b2, const void* w3, const float* b3,
    const void* wd, const float* bd, int B, int H, int W, int Cin, int Cmid,
    int Cout, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int cmid_p = round64(Cmid);
  const long long positions = (long long)B * (H + 1) * (W + 2);
  if (Cin % 8 || Cout % 8 || positions > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if (cmid_p <= 128)
    return launch<256, kFull>(x, y, nullptr, w1, b1, w2, b2, w3, b3, wd, bd,
                              B, H, W, Cin, cmid_p, Cout, positions, stream);
  if (wide_in_one(W, cmid_p, wd != nullptr))
    return launch<128, kFull>(x, y, nullptr, w1, b1, w2, b2, w3, b3, wd, bd,
                              B, H, W, Cin, cmid_p, Cout, positions, stream);
  if (h2 == nullptr) return (int)cudaErrorInvalidValue;
  const int err = launch<128, kFront>(x, y, h2, w1, b1, w2, b2, w3, b3, wd,
                                      bd, B, H, W, Cin, cmid_p, Cout,
                                      positions, stream);
  if (err != (int)cudaSuccess) return err;
  return launch<128, kBack>(x, y, h2, w1, b1, w2, b2, w3, b3, wd, bd, B, H,
                            W, Cin, cmid_p, Cout, positions, stream);
}
