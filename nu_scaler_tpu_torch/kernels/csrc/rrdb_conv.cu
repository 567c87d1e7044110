// The 3x3 SAME conv of RRDBNet's dense blocks in fp16 on the tensor cores,
// for Hopper (sm_90a): it reads its input as a channel prefix of a buffer in
// place, writes its output into a channel slice of a buffer, and applies the
// bias, LeakyReLU and up to two scaled residual adds in its epilogue.
//
// Replaces no TPU kernel: the JAX package has no RRDBNet. It replaces cuDNN
// (F.conv2d) on models/rrdbnet.py's serving path, with the concatenations of
// the dense connections and the separate bias, LeakyReLU and residual passes
// around each library conv.
//
// Layout. Every fp16 operand (x, out, r1, r2) is addressed by three strides
// in elements, an image's, an 8-channel plane's and a position's: channel c
// of position p = y * W + x of image n sits at
//   n * img + p * pos + (c / 8) * plane + c % 8.
// NHWC [N, H, W, C] is plane = 8, pos = C (a channel slice's C is its
// buffer's); the channel-blocked layout [N, C/8, H, W, 8], in which
// RRDBServing holds its growth buffers, is plane = H * W * 8, pos = 8.
// Blocked, a halo row of one plane is one contiguous run (66 positions,
// 1,056 bytes); in NHWC its positions' 16 bytes lie 2C bytes apart.
//
// What it computes (the function of rrdb_conv_cuda.rrdb_conv_plain). Input x
// fp16 [N, H, W, C] in either layout, of which channels 0 .. cin - 1 are
// read; packed weights (rrdb_conv_cuda.pack_weights) of an OIHW conv [Cout,
// cin, 3, 3]; an fp32 bias [Cout]. Per output position and channel, with
// zero outside the frame (SAME):
//   v = sum_{dy, dx, c} x[n, y+dy-1, x+dx-1, c] * k[o, c, dy, dx] + bias[o]
//   v = lrelu ? (v < 0 ? v * slope : v) : v
//   v = r1 ? r1[p, o] + s1 * v : v
//   v = r2 ? r2[p, o] + s2 * v : v
//   out[p, o] = fp16_rn(v)
// Products and sums in fp32 (the tensor cores' fp16 products are exact), the
// epilogue's multiplies and adds each rounded in fp32 (no FMA), one rounding
// to fp16 at the end. out, r1 and r2 are [N, H, W, Cout] views with strides
// of their own; out may be r2 (each element is read, then written, by one
// thread), never a channel that the conv reads. RRDBNet calls it as
//   conv k = 1..4 of an RDB: channels [0, 64 + 32(k-1)) of the RDB's buffer
//     in, its 32 channels [64 + 32(k-1), 64 + 32k) out, LeakyReLU 0.2;
//   conv5: all 192 channels in, 64 out (the next RDB's buffer), r1 = x (the
//     RDB's input, channels 0-63 of its buffer), s1 = 0.2; for an RRDB's
//     third RDB also r2 = x0 (the RRDB's input), s2 = 0.2;
//   conv_body: 64 -> 64, r1 = f0, s1 = 1; the upsampling convs: LeakyReLU.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense fp16, 3.35 TB/s;
// published peaks). At the body's 540 x 960 (518,400 positions) an RDB's
// five convs do 248.4 GFLOP, 0.251 ms at the peak. With each prefix read once
// and each slice written once, conv1-4 are bound by bytes (99, 133, 166, 199
// MB: 0.030, 0.040, 0.050, 0.059 ms) and conv5 by operations (114.7 GFLOP,
// 0.116 ms): about 0.30 ms an RDB. The 192-channel buffer (199 MB) does not
// fit the 50 MB L2, so those bytes come from device memory.
//
// Design: an implicit GEMM on warpgroup MMAs with both operands in shared
// memory (wgmma.mma_async m64nCOUTk16, f16 in, f32 sums), M = output
// positions, N = Cout (32 or 64), K = 9 * cin, in chunks of 16 channels.
//  * A tile is 8 rows x 64 columns of output positions; a block of 256
//    threads (two warpgroups), persistent over tiles (Layout::kBlocks a
//    SM). Warpgroup g owns tile rows 4g .. 4g + 3, one m64 accumulator a
//    row.
//  * Work items are (tile, 16-channel chunk); a stage holds one item: the
//    chunk's halo (10 x 66 positions) as two planes of 8 channels, and the
//    chunk's packed weights (9 taps x 16 channels x Cout). A plane stores
//    position after position, 16 bytes each: the no-swizzle K-major layout
//    of wgmma's descriptors (8 rows of 16 bytes a core matrix, the next 8
//    rows 128 bytes on, the next 8 channels a plane on). So the A operand of
//    tap (dy, dx) for tile row r is the descriptor at halo position
//    (r + dy) * 66 + dx: the nine shifted windows are address offsets,
//    nothing is copied.
//  * Every thread loads its share of each item by 16-byte cp.async
//    (src-size 0 outside the frame: SAME's zeros) into a ring of
//    Layout::kStages stages: at item i the block loads item i + kStages - 2
//    into the stage of item i - 2, whose wgmmas retired, and one
//    __syncthreads an item orders both. Consecutive threads copy
//    consecutive positions of one plane's halo row, so on a blocked input
//    a warp's 32 copies are 512 contiguous bytes, in global memory as in the
//    stage. An NHWC input takes the same walk (its 16-byte pieces lie 2C
//    bytes apart: correct, and as slow as the request count makes it; no
//    served launch reads NHWC).
//  * Why the layout and not TMA (PERF.md, section 6; H100, 540 x 960): on
//    NHWC a warp's copies touch 16 lines, 32 bytes of each, and TMA boxes of
//    these planes moved one 16-byte row (2C bytes from the next) every ~3.3
//    cycles a SM: both routes were bound by the number of requests, not by
//    bytes, so L2 hits did not help. TMA boxes of 64-channel rows would need
//    stages of 84.5 KB of halo. Blocked, the same cp.async loads walk whole
//    lines: with the epilogue cut out, conv1 takes 0.053 -> 0.044 ms and
//    conv5 0.131 -> 0.108 (its operations' bound is 0.116 at the published
//    peak; the card ran at 1,980 MHz).
//  * The epilogue reads the accumulators in registers (each thread holds two
//    neighbouring channels of 8 positions a row) and stores fp16 pairs
//    straight into the output slice (blocked: a warp's pairs of one plane
//    are 128 contiguous bytes); the residuals are read at the same
//    positions, all eight channel blocks of a position group before its
//    first store, since out may be r2 and a load after a store waits for it
//    (blocked, each block is its own line: one round trip a block). Which of
//    LeakyReLU and the residuals apply is a template parameter, and a
//    thread's halo source offsets are worked out once a tile: the SASS of a
//    first version spent ~100 instructions a stored pair and ~80 a halo
//    copy, as many issue slots an item as its wgmmas' tensor time.
//  * What bounds it now is the epilogue at Cout 64: one block a SM, so the
//    tensor cores idle while it stores (conv5 0.27 ms, 0.11 without it).
//    Prefetching r1 into shared memory by cp.async (a ring of four stages)
//    or tiles of four rows at two blocks a SM each saved ~0.025 ms of it.
// Every output sums its 9 * cin products in one order: chunk by chunk (16
// channels, one wgmma a tap), tap by tap.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;                // two warpgroups
constexpr int kTW = 64;                      // tile columns: one m64 row of positions
constexpr int kTH = 8;                       // tile rows
constexpr int kRowsPerWG = kTH / 2;          // m64 accumulators a warpgroup
constexpr int kHaloW = kTW + 2;
constexpr int kHaloPos = (kTH + 2) * kHaloW;
constexpr int kKC = 16;                      // input channels of a chunk: one wgmma a tap
constexpr int kPlanes = kKC / 8;             // 8-channel planes of a chunk
constexpr int kPlaneBytes = kHaloPos * 16;   // a plane: the positions' 16 bytes each
constexpr int kHaloBytes = kPlanes * kPlaneBytes;

template <int COUT>
struct Layout {
  static_assert(COUT == 32 || COUT == 64, "Cout is 32 or 64");
  static constexpr int kWBytes = 9 * kPlanes * COUT * 16;  // a chunk's packed weights
  static constexpr int kStage = kHaloBytes + kWBytes;
  // Cout 64: one block a SM (its accumulators take 128 registers a thread)
  // and five stages (198 KB); Cout 32: two blocks a SM of three stages each
  // (91 KB), so one block's epilogue and waits run under the other's wgmmas
  static constexpr int kBlocks = COUT == 64 ? 1 : 2;
  static constexpr int kStages = COUT == 64 ? 5 : 3;
  static constexpr int kAhead = kStages - 2;               // items loaded ahead of the newest
  static constexpr int kSmem = kStages * kStage + 128;     // + the base's alignment slack
  static_assert(kStage % 128 == 0, "stages stay 128-byte aligned");
  static_assert(kAhead >= 1, "the ring needs an item landing beside the one in flight");
};

// An operand's strides in elements (the header's layout): an image's, an
// 8-channel plane's, a position's.
struct Strides {
  int img;
  int plane;
  int pos;
};

// The epilogue's operands; which of them apply is the kernel's LRELU and
// NRES (0: none, 1: r1, 2: r1 then r2).
struct Epilogue {
  const float* bias;  // fp32 [Cout]
  __half* out;        // the output slice
  Strides o;
  float slope;
  const __half* r1;
  Strides t1;
  float s1;
  const __half* r2;
  Strides t2;
  float s2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's completed cp.async writes before the async proxy's
// (wgmma's) reads of shared memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// descriptor of a K-major operand without swizzle: core matrices of 8 rows x
// 16 bytes, rows 16 bytes apart; LBO `lbo` bytes to the next 8 K elements,
// SBO 128 bytes to the next 8 rows; layout type 0
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

// keeps the compiler from moving accesses to the accumulators across the
// wgmma fences and waits
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x COUT] (+)= a[64 x 16] * b[16 x COUT], both from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// one output: the sum + bias, then LeakyReLU and the residuals (each
// multiply and add rounded in fp32)
template <bool LRELU, int NRES>
__device__ __forceinline__ float finish(float sum, float bias, const Epilogue& ep, float r1, float r2) {
  float v = __fadd_rn(sum, bias);
  if (LRELU && v < 0.0f) v = __fmul_rn(v, ep.slope);
  if (NRES >= 1) v = __fadd_rn(r1, __fmul_rn(ep.s1, v));
  if (NRES >= 2) v = __fadd_rn(r2, __fmul_rn(ep.s2, v));
  return v;
}

template <int COUT, bool LRELU, int NRES>
__global__ void __launch_bounds__(kThreads, Layout<COUT>::kBlocks)
rrdb_conv_kernel(const __half* __restrict__ src, const Strides xs, const __half* __restrict__ wp,
                 const Epilogue ep, int n, int h, int w, int cin, int tiles_w, int tiles_h) {
  using L = Layout<COUT>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;        // warpgroup: tile rows kRowsPerWG * wg ..
  const int wr = (tid >> 5) & 3;  // warp of the warpgroup: columns 16 * wr .. of each row
  const int nch = cin / kKC;
  const int tiles = tiles_w * tiles_h * n;
  const int items = ((tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1) * nch;

  // item it of this block: tile blockIdx.x + (it / nch) * gridDim.x, chunk it % nch
  auto tile_of = [&](int it, int& ni, int& y0, int& x0) {
    int t = blockIdx.x + (it / nch) * gridDim.x;
    x0 = (t % tiles_w) * kTW;
    t /= tiles_w;
    y0 = (t % tiles_h) * kTH;
    ni = t / tiles_h;
  };
  // this thread's halo slots i = tid + kThreads * j: position i % kHaloPos
  // of plane i / kHaloPos (a warp walks one plane's rows), at byte i * 16 of
  // a stage (plane after plane, position after position); their element
  // offsets in the image of the tile being loaded (-1 outside the frame),
  // worked out once a tile
  constexpr int kSlots = (kHaloPos * kPlanes + kThreads - 1) / kThreads;
  const int chunk_stride = kPlanes * xs.plane;  // elements from one chunk to the next
  int hoff[kSlots];
  const __half* img = src;
  int loaded_tile = -1;
  auto load = [&](int it) {
    if (it / nch != loaded_tile) {
      loaded_tile = it / nch;
      int ni, y0, x0;
      tile_of(it, ni, y0, x0);
      img = src + static_cast<size_t>(ni) * xs.img;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int i = tid + kThreads * j;
        const int pos = i % kHaloPos, plane = i / kHaloPos;
        const int gy = y0 - 1 + pos / kHaloW, gx = x0 - 1 + pos % kHaloW;
        hoff[j] = gy >= 0 && gy < h && gx >= 0 && gx < w ? (gy * w + gx) * xs.pos + plane * xs.plane : -1;
      }
    }
    const int q = it % nch;
    const uint32_t st = base + (it % S) * L::kStage;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = tid + kThreads * j;
      if (i < kHaloPos * kPlanes) {
        cp_async16(st + i * 16, hoff[j] >= 0 ? img + hoff[j] + q * chunk_stride : src,
                   hoff[j] >= 0 ? 16u : 0u);
      }
    }
    const __half* wq = wp + static_cast<size_t>(q) * (L::kWBytes / 2);
#pragma unroll
    for (int i = tid; i < L::kWBytes / 16; i += kThreads) cp_async16(st + kHaloBytes + i * 16, wq + i * 8, 16u);
  };
  // this thread's bias pairs: channels 8 nb + 2 (lane % 4) ..
  float2 bias[COUT / 8];
#pragma unroll
  for (int nb = 0; nb < COUT / 8; ++nb) bias[nb] = *reinterpret_cast<const float2*>(ep.bias + nb * 8 + (lane & 3) * 2);

#pragma unroll
  for (int d = 0; d < L::kAhead; ++d) {
    if (d < items) load(d);
    cp_async_commit();
  }
  float acc[kRowsPerWG][COUT / 2];
  for (int it = 0; it < items; ++it) {
    const int q = it % nch;
    const uint32_t halo = base + (it % S) * L::kStage;
    const uint32_t wst = halo + kHaloBytes;
    cp_async_wait<L::kAhead - 1>();  // item it has landed ...
    fence_proxy_async();
    __syncthreads();  // ... for every thread; item it - 2's wgmmas retired in both warpgroups
    if (it + L::kAhead < items) load(it + L::kAhead);  // into item it - 2's stage
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < kRowsPerWG; ++i) fence_acc(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t db = desc(wst + tap * kPlanes * COUT * 16, COUT * 16);
#pragma unroll
      for (int i = 0; i < kRowsPerWG; ++i) {
        const int r = wg * kRowsPerWG + i;
        wgmma_ss(acc[i], desc(halo + ((r + dy) * kHaloW + dx) * 16, kPlaneBytes), db, q | tap);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // item it - 1 retires
    if (q != nch - 1) continue;

    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kRowsPerWG; ++i) fence_acc(acc[i]);
    int ni, y0, x0;
    tile_of(it, ni, y0, x0);
#pragma unroll
    for (int i = 0; i < kRowsPerWG; ++i) {
      const int y = y0 + wg * kRowsPerWG + i;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = x0 + wr * 16 + (lane >> 2) + hh * 8;
        if (y >= h || x >= w) continue;
        const int p = y * w + x, c = (lane & 3) * 2;
        __half* out = ep.out + static_cast<size_t>(ni) * ep.o.img + p * ep.o.pos + c;
        const __half* r1 = NRES >= 1 ? ep.r1 + static_cast<size_t>(ni) * ep.t1.img + p * ep.t1.pos + c : nullptr;
        const __half* r2 = NRES >= 2 ? ep.r2 + static_cast<size_t>(ni) * ep.t2.img + p * ep.t2.pos + c : nullptr;
        // every residual pair first, then the stores: out may be r2, so a
        // load after a store would wait for it, a round trip a channel block
        __half2 h1[COUT / 8], h2[COUT / 8];
#pragma unroll
        for (int nb = 0; nb < COUT / 8; ++nb) {
          if (NRES >= 1) h1[nb] = *reinterpret_cast<const __half2*>(r1 + nb * ep.t1.plane);
          if (NRES >= 2) h2[nb] = *reinterpret_cast<const __half2*>(r2 + nb * ep.t2.plane);
        }
#pragma unroll
        for (int nb = 0; nb < COUT / 8; ++nb) {
          float2 a1 = make_float2(0.0f, 0.0f), a2 = a1;
          if (NRES >= 1) a1 = __half22float2(h1[nb]);
          if (NRES >= 2) a2 = __half22float2(h2[nb]);
          const float v0 = finish<LRELU, NRES>(acc[i][4 * nb + 2 * hh], bias[nb].x, ep, a1.x, a2.x);
          const float v1 = finish<LRELU, NRES>(acc[i][4 * nb + 2 * hh + 1], bias[nb].y, ep, a1.y, a2.y);
          *reinterpret_cast<__half2*>(out + nb * ep.o.plane) = __floats2half2_rn(v0, v1);
        }
      }
    }
  }
}

template <int COUT, bool LRELU, int NRES>
int launch(int device, const void* x, const Strides& xs, int n, int h, int w, int cin, const void* wp,
           const Epilogue& ep, cudaStream_t stream) {
  using L = Layout<COUT>;
  auto kernel = rrdb_conv_kernel<COUT, LRELU, NRES>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  int sms = 0;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (w + kTW - 1) / kTW;
  const int tiles_h = (h + kTH - 1) / kTH;
  const long long tiles = static_cast<long long>(tiles_w) * tiles_h * n;
  const long long slots = static_cast<long long>(sms) * L::kBlocks;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(static_cast<const __half*>(x), xs,
                                               static_cast<const __half*>(wp), ep, n, h, w, cin, tiles_w,
                                               tiles_h);
  return static_cast<int>(cudaGetLastError());
}

// the epilogues RRDBNet's convs use: LeakyReLU (conv1-4, the upsampling
// convs), one residual (conv5, conv_body), two (an RRDB's last conv5)
int dispatch(int device, const void* x, const Strides& xs, int n, int h, int w, int cin, const void* wp,
             int cout, const Epilogue& ep, int lrelu, int nres, cudaStream_t s) {
  if (lrelu && nres == 0) {
    return cout == 32 ? launch<32, true, 0>(device, x, xs, n, h, w, cin, wp, ep, s)
                      : launch<64, true, 0>(device, x, xs, n, h, w, cin, wp, ep, s);
  }
  if (!lrelu && cout == 64 && nres == 1) return launch<64, false, 1>(device, x, xs, n, h, w, cin, wp, ep, s);
  if (!lrelu && cout == 64 && nres == 2) return launch<64, false, 2>(device, x, xs, n, h, w, cin, wp, ep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// whether an operand of c channels at p, `bytes`-aligned, has strides of
// one of the two layouts (NHWC: planes 8 apart, positions past the channels;
// blocked: positions 8 apart, planes past an image's positions), one image
// within an int's offsets, images past one another
bool view_ok(const void* p, uintptr_t bytes, const Strides& s, int n, int h, int w, int c) {
  const long long hw = static_cast<long long>(h) * w;
  const bool nhwc = s.plane == 8 && s.pos >= c && s.pos % 8 == 0;
  const bool blocked = s.pos == 8 && s.plane >= 8 * hw && s.plane % 8 == 0;
  const long long extent = (hw - 1) * s.pos + static_cast<long long>(c / 8 - 1) * s.plane + 8;
  return aligned(p, bytes) && c % 8 == 0 && (nhwc || blocked) && extent <= 0x7fffffffLL &&
         (n == 1 || s.img >= extent);
}

}  // namespace

extern "C" {

// The conv: x fp16 [n, h, w, c_total] (channels 0 .. cin - 1 read), wp the
// packed fp16 weights, bias fp32 [cout], out an fp16 [n, h, w, cout] view;
// r1 / r2 fp16 views like out, or NULL; each view given by its image, plane
// and position strides in elements (the header's layout), either layout for
// each; the epilogue one of dispatch's. Returns 0 on success, else a
// cudaError_t code (see nu_cuda_error_string).
int nu_rrdb_conv(int device, const void* x, int x_img, int x_plane, int x_pos, int n, int h, int w,
                 int c_total, int cin, const void* wp, const float* bias, int cout,
                 void* out, int out_img, int out_plane, int out_pos, int lrelu, float slope,
                 const void* r1, int r1_img, int r1_plane, int r1_pos, float s1,
                 const void* r2, int r2_img, int r2_plane, int r2_pos, float s2, void* stream) {
  const Strides xs{x_img, x_plane, x_pos}, os{out_img, out_plane, out_pos};
  const Strides t1{r1_img, r1_plane, r1_pos}, t2{r2_img, r2_plane, r2_pos};
  if (n < 1 || h < 1 || w < 1 || cin < kKC || cin % kKC || cin > c_total || (cout != 32 && cout != 64) ||
      !view_ok(x, 16, xs, n, h, w, c_total) || !view_ok(out, 4, os, n, h, w, cout) ||
      (r1 && !view_ok(r1, 4, t1, n, h, w, cout)) || (r2 && !view_ok(r2, 4, t2, n, h, w, cout)) ||
      (r2 && !r1) || !aligned(wp, 16) || bias == nullptr || !aligned(bias, 8) ||
      static_cast<long long>((w + kTW - 1) / kTW) * h * n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const Epilogue ep{bias, static_cast<__half*>(out), os, slope,
                    static_cast<const __half*>(r1), t1, s1,
                    static_cast<const __half*>(r2), t2, s2};
  const int nres = r2 ? 2 : r1 ? 1 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(device, x, xs, n, h, w, cin, wp, cout, ep, lrelu, nres, s);
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
