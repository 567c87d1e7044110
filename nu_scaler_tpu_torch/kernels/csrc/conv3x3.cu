// 3x3 SAME convolution in bf16 on the tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel nu_scaler_tpu/kernels/conv_pallas.py:50
// make_conv3x3 (-> _make_kernel :26): the learned tier's trunk convs.
//
// What it computes (the function of conv_cuda.conv3x3_plain). Input x bf16
// NHWC [N, H, W, Cin], weights bf16 [Cout, 3, 3, Cin] (the HWIO weights
// repacked by the wrapper, conv_cuda.pack_weights), bias b bf16 [Cout]; Cin
// and Cout multiples of 128. out[n, y, x, o] = bf16_rn(act(
// sum_{dy, dx, c} x[n, y+dy-1, x+dx-1, c] * k[dy, dx, c, o] + float(b[o])))
// with zero outside the frame (SAME) and act = ReLU or identity: products
// and sums in fp32, the bias added in fp32 after the sum, one rounding to
// bf16 at the end, as the Pallas kernel does. With round_sum the sum is
// rounded to bf16 first and the bias added to it in bf16 (the sum of two
// bf16 values in fp32, rounded to bf16): the rounding of the JAX serving
// graph's XLA conv followed by its bias add (esrgan_lite.py:1025-1030),
// which the learned tier serves.
//
// The int8-grid mode (nu_conv3x3_q) replaces the XLA conv _conv_i8
// (nu_scaler_tpu/models/esrgan_lite.py:719) of the int8 learned ladders. x
// holds integers in [-127, 127] and the weights integers in [-127, 127], both
// as bf16 (exact); the epilogue reads an fp32 scale[o] = f32(dq) * f32(ax/127)
// and an optional fp32 bias[o]: out = bf16_rn(act(__fadd_rn(__fmul_rn(sum,
// scale[o]), bias[o]))), no FMA. Every product is an integer below 2^14 and,
// on the committed weights, every partial sum stays below 0.311 * 2^24 for
// any input (conv_cuda.int8_sum_bound), so the fp32 sums are the int32 sums
// of _conv_i8 whatever their order: the mode is bit-equal to its plain
// version. The main loop is the bf16 one; Hopper's s8 wgmma is a later step.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16 on the tensor
// cores, 3.35 TB/s; published peaks). One output position of a 128 -> 128
// conv costs 2*9*128*128 = 294,912 operations and moves 512 bytes (its
// input and output row once each): 576 operations per byte, twice the card's
// ridge (295). At the learned tier's 1080p trunk grid (270 x 480) that is
// 38.2 GFLOP, 38.6 us, against 66.7 MB, 19.9 us: operations bound it.
//
// Design: an implicit GEMM, M = output positions, N = Cout, K = 9*Cin, on
// warpgroup MMAs (wgmma.mma_async m64n128k16, A from registers, B from
// shared memory), with hand-written PTX.
//  * A block of 256 threads (two warpgroups) owns a TH x TW tile of 256
//    output positions and 128 output channels; one block per SM. Grid:
//    x = spatial tiles, y = Cout / 128, z = batch. Warpgroup g owns tile
//    positions 128*g .. 128*g + 127 as two m64n128 fp32 accumulators
//    (128 registers a thread).
//  * The halo: for each chunk of 128 input channels, the tile's input with a
//    one-position border, (TH + 2) x (TW + 2) positions x 128 channels,
//    lands in shared memory by 16-byte cp.async (src-size 0 outside the
//    frame: SAME's zeros). A position's row is padded from 256 to 272 bytes
//    so that ldmatrix's eight rows fall on distinct banks.
//  * A in registers: for tap (dy, dx), each lane's ldmatrix.x4 row address
//    is its output position's halo row shifted by (dy, dx), so the nine
//    shifted windows are address offsets and nothing is copied. The x4
//    fragment is the m16n8k16 A layout, which is wgmma's register-A layout
//    for the warp's 16 rows of the warpgroup's 64.
//  * B from shared memory: a stage is one (tap, 64-channel) slice of the
//    packed weights, 128 rows (Cout) of 128 bytes, K-major, with the 128-byte
//    swizzle (16-byte chunk c of row r stored at chunk c ^ (r & 7)); the
//    wgmma descriptor takes start >> 4, SBO 1024 bytes (8 rows) and layout
//    type 1, and moves 32 bytes along K per k16 step. NS stages form a ring
//    fed by cp.async groups: while stage s is multiplied, stages s + 1 ..
//    s + NS - 2 are landing, and one wgmma group (stage s - 1) is still in
//    flight. The A fragments alternate between two register sets, so a
//    group's A is never overwritten before it retires.
//  * Epilogue in registers: each thread holds pairs of neighbouring
//    channels; (round the sum to bf16 with round_sum,) add the bias, ReLU,
//    round to bf16, stage the 256 x 128 tile in shared memory (the halo's
//    space) and write 16-byte stores, masked at the right and bottom edges.
//  * Every block reads the 9*Cin*128 weights of its channel tile through L2
//    once per 256 positions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // two warpgroups
constexpr int kBM = 256;            // output positions of a tile
constexpr int kBN = 128;            // output channels of a tile
constexpr int kKC = 128;            // input channels of a halo chunk
constexpr int kRowBytes = 272;      // a halo position's or staged output's row: 256 + 16 bytes
constexpr int kStageBytes = 16384;  // one weight stage: 128 rows x 64 bf16
constexpr int kSteps = 18;          // stages per halo chunk: 9 taps x 2 halves of 64 channels

template <int TH, int TW, int NS>
struct Layout {
  static_assert(TH * TW == kBM && TW % 16 == 0, "a tile is 256 positions, rows of 16k");
  static_assert(NS >= 3, "the ring needs a stage landing and one in flight");
  static constexpr int kHaloW = TW + 2;
  static constexpr int kHaloBytes = (TH + 2) * kHaloW * kRowBytes;
  static constexpr int kRing = (kHaloBytes + 1023) / 1024 * 1024;  // 1024-byte aligned: the swizzle's atom
  static constexpr int kSmem = kRing + NS * kStageBytes + 1024;    // + the base's alignment slack
  static_assert(kBM * kRowBytes <= kRing, "the epilogue's staging must fit in the halo's space");
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// descriptor of a K-major operand with the 128-byte swizzle: start >> 4,
// LBO 1 (unused), SBO 1024 bytes >> 4, layout type 1 (bits 62-63)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x 128] += a[64 x 16] (registers) * b[16 x 128] (shared, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The epilogue's modes: one rounding (the Pallas kernel's), the sum rounded
// to bf16 before the bias (the serving graph's), the int8 grid's dequantise.
enum Epilogue { kSingle = 0, kRoundSum = 1, kQGrid = 2 };

// sum -> the value rounded to bf16: `scale` is read by kQGrid only; `bias`
// is the bf16 bias as fp32, or kQGrid's fp32 bias (-0.0f without one: x +
// -0 == x for every x, so the add is then the identity)
template <bool RELU, int EPI>
__device__ __forceinline__ float finish(float sum, float scale, float bias) {
  if (EPI == kRoundSum) sum = __bfloat162float(__float2bfloat16_rn(sum));
  if (EPI == kQGrid) sum = __fmul_rn(sum, scale);
  float val = __fadd_rn(sum, bias);
  if (RELU) val = fmaxf(val, 0.0f);
  return val;
}

template <int TH, int TW, int NS, bool RELU, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ kp,
               const void* __restrict__ b, const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int h, int w, int cin, int cout, int tiles_w) {
  using L = Layout<TH, TW, NS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t halo = (raw + 1023u) & ~1023u;
  const uint32_t ring = halo + L::kRing;
  unsigned char* stage_out = smem_raw + (halo - raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;          // warpgroup: tile positions 128*wg ..
  const int wr = (tid >> 5) & 3;    // warp of the warpgroup: rows 16*wr .. of each accumulator
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * kBN;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  const __nv_bfloat16* xi = x + img * cin;

  // this lane's ldmatrix row for accumulator j at tap (0, 0): output position
  // m (its window's top-left corner in the halo), channels 8 * (lane / 16) ..
  uint32_t a_row[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = wg * 128 + j * 64 + wr * 16 + (lane & 15);
    a_row[j] = halo + ((m / TW) * L::kHaloW + m % TW) * kRowBytes + (lane >> 4) * 16;
  }

  auto load_halo = [&](int c0) {
    for (int i = tid; i < (TH + 2) * L::kHaloW * 16; i += kThreads) {
      const int pos = i >> 4, v = i & 15;
      const int gy = y0 - 1 + pos / L::kHaloW, gx = x0 - 1 + pos % L::kHaloW;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const __nv_bfloat16* src = in ? xi + (static_cast<size_t>(gy) * w + gx) * cin + c0 + v * 8 : x;
      cp_async16(halo + pos * kRowBytes + v * 16, src, in ? 16u : 0u);
    }
  };
  // stage g: halo chunk g / 18, tap (g % 18) / 2, channels 64 * (g % 2) ..
  auto load_stage = [&](int g) {
    const int s = g % kSteps;
    const int c = (g / kSteps) * kKC + (s & 1) * 64;
    const uint32_t dst = ring + (g % NS) * kStageBytes;
#pragma unroll
    for (int r = 0; r < kBN * 8 / kThreads; ++r) {
      const int i = tid + r * kThreads, row = i >> 3, q = i & 7;
      const __nv_bfloat16* src = kp + (static_cast<size_t>(n0 + row) * 9 + (s >> 1)) * cin + c + q * 8;
      cp_async16(dst + row * 128 + ((q ^ (row & 7)) << 4), src, 16u);
    }
  };

  float acc[2][64];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.0f;
  uint32_t af[2][4][2][4];  // [register set][k16 step][accumulator][ldmatrix register]

  const int total = (cin / kKC) * kSteps;
  load_halo(0);
  cp_async_commit();
#pragma unroll
  for (int g = 0; g < NS - 2; ++g) {
    load_stage(g);
    cp_async_commit();
  }

  for (int g0 = 0; g0 < total; g0 += 2) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {  // p: the register set, and g's parity
      const int g = g0 + p;
      const int s = g % kSteps;
      if (s == 0 && g > 0) {  // the next chunk of Cin: every warp is done with the halo
        __syncthreads();
        load_halo((g / kSteps) * kKC);
        cp_async_commit();
        cp_async_wait<0>();
      }
      cp_async_wait<NS - 3>();  // stage g has landed
      fence_proxy_async();
      __syncthreads();  // ... for every thread; stage g - 2's wgmmas have retired
      if (g + NS - 2 < total) load_stage(g + NS - 2);  // into stage g - 2's slot
      cp_async_commit();

      const int tap = s >> 1, dy = tap / 3, dx = tap - 3 * dy;
      const uint32_t off = (dy * L::kHaloW + dx) * kRowBytes + (s & 1) * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j) ldmatrix_x4(af[p][kk][j], a_row[j] + off + kk * 32);
      wgmma_fence();
      const uint32_t bst = ring + (g % NS) * kStageBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j) wgmma_m64n128k16_rs(acc[j], af[p][kk][j], desc_sw128(bst + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();  // stage g - 1 retires; stage g stays in flight
    }
  }
  wgmma_wait<0>();

  // epilogue: registers -> (scale,) bias, ReLU, bf16 -> the tile staged in
  // shared memory (the halo's space) -> 16-byte stores
  __syncthreads();
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    const int col = nb * 8 + (lane & 3) * 2;
    float b0, b1, s0 = 1.0f, s1 = 1.0f;
    if (EPI == kQGrid) {
      const float* bq = static_cast<const float*>(b);
      s0 = scale[n0 + col];
      s1 = scale[n0 + col + 1];
      b0 = bq ? bq[n0 + col] : -0.0f;
      b1 = bq ? bq[n0 + col + 1] : -0.0f;
    } else {
      const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(b);
      b0 = __bfloat162float(bb[n0 + col]);
      b1 = __bfloat162float(bb[n0 + col + 1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wg * 128 + j * 64 + wr * 16 + (lane >> 2) + half * 8;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            finish<RELU, EPI>(acc[j][4 * nb + 2 * half], s0, b0),
            finish<RELU, EPI>(acc[j][4 * nb + 2 * half + 1], s1, b1));
        *reinterpret_cast<__nv_bfloat162*>(stage_out + m * kRowBytes + col * 2) = v;
      }
  }
  __syncthreads();
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int m = i >> 4, v = i & 15;
    const int gy = y0 + m / TW, gx = x0 + m % TW;
    if (gy >= h || gx >= w) continue;
    *reinterpret_cast<uint4*>(out + (img + static_cast<size_t>(gy) * w + gx) * cout + n0 + v * 8) =
        *reinterpret_cast<const uint4*>(stage_out + m * kRowBytes + v * 16);
  }
}

template <int TH, int TW, int NS, bool RELU, int EPI>
int launch(const void* x, const void* k, const void* b, const float* scale, void* out, int n,
           int h, int w, int cin, int cout, cudaStream_t stream) {
  constexpr int smem = Layout<TH, TW, NS>::kSmem;
  auto kernel = conv3x3_kernel<TH, TW, NS, RELU, EPI>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (w + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, cout / kBN, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k), b, scale,
      static_cast<__nv_bfloat16*>(out), h, w, cin, cout, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <int TH, int TW, int NS>
int dispatch(const void* x, const void* k, const void* b, void* out, int n, int h, int w, int cin,
             int cout, int relu, int round_sum, cudaStream_t s) {
  if (relu) {
    return round_sum ? launch<TH, TW, NS, true, kRoundSum>(x, k, b, nullptr, out, n, h, w, cin, cout, s)
                     : launch<TH, TW, NS, true, kSingle>(x, k, b, nullptr, out, n, h, w, cin, cout, s);
  }
  return round_sum ? launch<TH, TW, NS, false, kRoundSum>(x, k, b, nullptr, out, n, h, w, cin, cout, s)
                   : launch<TH, TW, NS, false, kSingle>(x, k, b, nullptr, out, n, h, w, cin, cout, s);
}

bool bad_shape(int n, int h, int w, int cin, int cout, int tile_w) {
  return n < 1 || n > 65535 || h < 1 || w < 1 || cin < kKC || cin % kKC || cout < kBN ||
         cout % kBN || cout / kBN > 65535 ||
         static_cast<long long>((w + tile_w - 1) / tile_w) *
                 ((h + kBM / tile_w - 1) / (kBM / tile_w)) >
             0x7fffffffLL;
}

}  // namespace

extern "C" {

// The conv with a chosen tile width (16: 16 x 16 positions, 32: 8 x 32) and
// ring depth (3 or 4 stages). Returns 0 on success, else a cudaError_t code
// (see nu_cuda_error_string).
int nu_conv3x3_variant(int device, const void* x, const void* k, const void* b, void* out, int n,
                       int h, int w, int cin, int cout, int relu, int round_sum, int tile_w,
                       int stages, void* stream) {
  if ((tile_w != 16 && tile_w != 32) || (stages != 3 && stages != 4) ||
      bad_shape(n, h, w, cin, cout, tile_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_w == 16) {
    return stages == 3 ? dispatch<16, 16, 3>(x, k, b, out, n, h, w, cin, cout, relu, round_sum, s)
                       : dispatch<16, 16, 4>(x, k, b, out, n, h, w, cin, cout, relu, round_sum, s);
  }
  return stages == 3 ? dispatch<8, 32, 3>(x, k, b, out, n, h, w, cin, cout, relu, round_sum, s)
                     : dispatch<8, 32, 4>(x, k, b, out, n, h, w, cin, cout, relu, round_sum, s);
}

// The conv at the default tile (16 x 16 positions, 4 stages).
int nu_conv3x3(int device, const void* x, const void* k, const void* b, void* out, int n, int h,
               int w, int cin, int cout, int relu, int round_sum, void* stream) {
  return nu_conv3x3_variant(device, x, k, b, out, n, h, w, cin, cout, relu, round_sum, 16, 4,
                            stream);
}

// The int8-grid mode at the default tile: x and k integer-valued bf16,
// scale fp32 [cout], b fp32 [cout] or NULL (no bias).
int nu_conv3x3_q(int device, const void* x, const void* k, const float* scale, const float* b,
                 void* out, int n, int h, int w, int cin, int cout, int relu, void* stream) {
  if (scale == nullptr || bad_shape(n, h, w, cin, cout, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? launch<16, 16, 4, true, kQGrid>(x, k, b, scale, out, n, h, w, cin, cout, s)
              : launch<16, 16, 4, false, kQGrid>(x, k, b, scale, out, n, h, w, cin, cout, s);
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
