// The 3x3 SAME conv's device code on Hopper (sm_90a), shared by conv3x3.cu
// (one tile a block) and trunk_fused.cu (a persistent block walking the
// tiles of every layer of the trunk).
//
// conv_tile is the main loop over one tile: TH x TW = 256 output positions
// of one image and 128 output channels, an implicit GEMM on warpgroup MMAs
// (wgmma.mma_async m64n128k16, A from registers, B from shared memory):
//  * A block of 256 threads (two warpgroups). Warpgroup g owns tile
//    positions 128*g .. 128*g + 127 as two m64n128 fp32 accumulators (128
//    registers a thread).
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
//    packed weights [Cout, 3, 3, Cin], 128 rows (Cout) of 128 bytes,
//    K-major, with the 128-byte swizzle (16-byte chunk c of row r stored at
//    chunk c ^ (r & 7)); the wgmma descriptor takes start >> 4, SBO 1024
//    bytes (8 rows) and layout type 1, and moves 32 bytes along K per k16
//    step. NS stages form a ring fed by cp.async groups: while stage s is
//    multiplied, stages s + 1 .. s + NS - 2 are landing, and one wgmma group
//    (stage s - 1) is still in flight. The A fragments alternate between two
//    register sets, so a group's A is never overwritten before it retires.
// Every output sums its 9 * Cin products in one order: halo chunk by chunk,
// tap by tap, 64 channels a stage, 16 a wgmma. The tile's shape, its place
// in the frame and the ring's depth change no output's chain, so every
// caller of conv_tile gives the same bytes for the same conv.
//
// stage_tile is the epilogue in registers: each thread holds pairs of
// neighbouring channels; (round the sum to bf16 with kRoundSum, or scale it
// with kQGrid,) add the bias, ReLU, round to bf16, and stage the 256 x 128
// tile in shared memory (the halo's space) for 16-byte stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace nu_conv {

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

// The main loop over one tile: the fp32 sums of output positions (y0, x0) ..
// (y0 + TH - 1, x0 + TW - 1) of image `xi` [h, w, cin] and output channels
// n0 .. n0 + 127 of the packed weights `kp` [Cout, 3, 3, Cin] into `acc`,
// every wgmma retired on return. `halo` is the 1024-byte-aligned base of
// Layout<TH, TW, NS>'s shared memory; the caller has synchronised the block
// since the last read of it.
template <int TH, int TW, int NS>
__device__ __forceinline__ void conv_tile(uint32_t halo, const __nv_bfloat16* __restrict__ xi,
                                          const __nv_bfloat16* __restrict__ kp, int h, int w,
                                          int cin, int y0, int x0, int n0, float (&acc)[2][64]) {
  using L = Layout<TH, TW, NS>;
  const uint32_t ring = halo + L::kRing;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;          // warpgroup: tile positions 128*wg ..
  const int wr = (tid >> 5) & 3;    // warp of the warpgroup: rows 16*wr .. of each accumulator

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
      const __nv_bfloat16* src = in ? xi + (static_cast<size_t>(gy) * w + gx) * cin + c0 + v * 8 : xi;
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
}

// The epilogue: the sums in `acc` -> (scale,) bias, ReLU, bf16 -> the tile
// staged in shared memory at `stage_out`, row m (a tile position) of
// kRowBytes holding its 128 channels. Synchronises the block before (the
// halo's space is reused) and after (the staged tile is complete).
template <bool RELU, int EPI>
__device__ __forceinline__ void stage_tile(const float (&acc)[2][64], unsigned char* stage_out,
                                           const void* __restrict__ b,
                                           const float* __restrict__ scale, int n0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int wr = (tid >> 5) & 3;
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
}

}  // namespace nu_conv
