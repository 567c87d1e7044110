// 3x3 SAME convolution in bf16 on the tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel nu_scaler_tpu/kernels/conv_pallas.py:50
// make_conv3x3 (-> _make_kernel :26): the learned tier's trunk convs.
//
// What it computes (the function of conv_cuda.conv3x3_plain). Input x bf16
// NHWC [N, H, W, Cin], weights k bf16 HWIO [3, 3, Cin, Cout], bias b bf16
// [Cout]; Cin and Cout multiples of 128. out[n, y, x, o] = bf16_rn(act(
// sum_{dy, dx, c} x[n, y+dy-1, x+dx-1, c] * k[dy, dx, c, o] + float(b[o])))
// with zero outside the frame (SAME) and act = ReLU or identity: products
// and sums in fp32, the bias added in fp32 after the sum, one rounding to
// bf16 at the end, as the Pallas kernel does. With round_sum the sum is
// rounded to bf16 first and the bias added to it in bf16 (the sum of two
// bf16 values in fp32, rounded to bf16): the rounding of the JAX serving
// graph's XLA conv followed by its bias add (esrgan_lite.py:1025-1030),
// which the learned tier serves.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16 on the tensor
// cores, 3.35 TB/s; published peaks). One output position of a 128 -> 128
// conv costs 2*9*128*128 = 294,912 operations and moves 512 bytes (its
// input and output row once each): 576 operations per byte, twice the card's
// ridge (295). At the learned tier's 1080p trunk grid (270 x 480) that is
// 38.2 GFLOP, 38.6 us, against 66.7 MB, 19.9 us: operations bound it.
//
// Design (a first one, kept simple): an implicit GEMM, M = output positions,
// N = Cout, K = 9*Cin, on nvcuda::wmma 16x16x16 bf16 fragments with fp32
// accumulators (mma.sync underneath; wgmma and TMA are later work).
//  * A block of 256 threads (8 warps) owns an 8 x 16 tile of output
//    positions (M = 128) and 128 output channels (N = 128). Grid: x = spatial
//    tiles, y = Cout / 128, z = batch.
//  * For each 32-channel chunk of Cin it stages in shared memory the tile's
//    input with a one-position halo, 10 x 18 x 32 (zero outside the frame:
//    SAME), and the 9 taps' [32, 128] weight slices. A fragment row of A is
//    16 consecutive positions of one tile row, so tap (dy, dx) reads the halo
//    shifted by (dy, dx) with no copy.
//  * Warp (wm, wn) computes tile rows 2*wm, 2*wm + 1 against channels
//    64*wn .. 64*wn + 63: 2 x 4 accumulator fragments.
//  * Epilogue: the accumulators go through shared memory (fp32); each thread
//    (rounds the sum to bf16 with round_sum,) adds the bias, applies ReLU,
//    rounds 8 channels to bf16 and writes them
//    as one 16-byte store, masked at the frame's right and bottom edges.
//  * Shared memory: 17,280 bytes of halo and 78,336 of weights (rows padded
//    by 16 and 8 elements against bank conflicts) = 95,616 bytes, dynamic
//    (above the 48 KB static limit), two blocks per SM. The staging buffer of
//    the epilogue (67,584 bytes) reuses it.
// Loads are plain 16-byte loads with no pipelining across chunks; every block
// reads all 9*Cin*128 weights of its channel tile through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kTH = 8;                        // output rows of a tile
constexpr int kTW = 16;                       // output columns of a tile (one fragment's rows)
constexpr int kBM = kTH * kTW;                // output positions of a tile
constexpr int kBN = 128;                      // output channels of a tile
constexpr int kKC = 32;                       // input channels staged at a time
constexpr int kHaloW = kTW + 2;
constexpr int kHaloPos = (kTH + 2) * kHaloW;  // 180 positions
constexpr int kHaloLd = kKC + 16;             // bf16 per halo position (96 bytes)
constexpr int kWLd = kBN + 8;                 // bf16 per weight row (272 bytes)
constexpr int kStLd = kBN + 4;                // fp32 per staged output row
constexpr int kThreads = 256;
constexpr int kHaloBytes = kHaloPos * kHaloLd * 2;
constexpr int kWBytes = 9 * kKC * kWLd * 2;
constexpr int kSmem = kHaloBytes + kWBytes;
static_assert(kBM * kStLd * 4 <= kSmem, "the epilogue's staging must fit");
static_assert(kHaloBytes % 128 == 0, "weights must start 128-byte aligned");

template <bool RELU, bool ROUND_SUM>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out, int h,
               int w, int cin, int cout, int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wts = reinterpret_cast<__nv_bfloat16*>(smem + kHaloBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // tile rows 2*wm, 2*wm + 1
  const int wn = warp >> 2;  // channels 64*wn .. 64*wn + 63
  const int y0 = (blockIdx.x / tiles_w) * kTH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int n0 = blockIdx.y * kBN;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int c0 = 0; c0 < cin; c0 += kKC) {
    __syncthreads();  // the previous chunk's fragments are read
    // the halo: 180 positions x 4 vectors of 8 channels, zero outside the frame
    for (int i = tid; i < kHaloPos * (kKC / 8); i += kThreads) {
      const int pos = i / (kKC / 8), v = i % (kKC / 8);
      const int gy = y0 - 1 + pos / kHaloW, gx = x0 - 1 + pos % kHaloW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        val = __ldg(reinterpret_cast<const uint4*>(
            x + (img + static_cast<size_t>(gy) * w + gx) * cin + c0 + v * 8));
      }
      *reinterpret_cast<uint4*>(halo + pos * kHaloLd + v * 8) = val;
    }
    // the weights: 9 taps x 32 input channels x 16 vectors of 8 outputs
    for (int i = tid; i < 9 * kKC * (kBN / 8); i += kThreads) {
      const int row = i / (kBN / 8), v = i % (kBN / 8);
      const int tap = row / kKC, c = row % kKC;
      *reinterpret_cast<uint4*>(wts + row * kWLd + v * 8) = __ldg(reinterpret_cast<const uint4*>(
          k + (static_cast<size_t>(tap) * cin + c0 + c) * cout + n0 + v * 8));
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ty = 2 * wm + i;
          wmma::load_matrix_sync(a[i], halo + ((ty + dy) * kHaloW + dx) * kHaloLd + kk, kHaloLd);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::load_matrix_sync(bf[j], wts + (tap * kKC + kk) * kWLd + wn * 64 + j * 16, kWLd);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
      }
    }
  }

  // epilogue: accumulators -> shared fp32 -> bias, ReLU, bf16, 16-byte stores
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage + (2 * wm + i) * 16 * kStLd + wn * 64 + j * 16, acc[i][j],
                              kStLd, wmma::mem_row_major);
    }
  __syncthreads();
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int p = i / (kBN / 8), v = i % (kBN / 8);
    const int gy = y0 + p / kTW, gx = x0 + p % kTW;
    if (gy >= h || gx >= w) continue;
    const float* src = stage + p * kStLd + v * 8;
    const __nv_bfloat16* bias = b + n0 + v * 8;
    __align__(16) __nv_bfloat16 res[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float sum = src[e];
      if (ROUND_SUM) sum = __bfloat162float(__float2bfloat16_rn(sum));
      float val = __fadd_rn(sum, __bfloat162float(bias[e]));
      if (RELU) val = fmaxf(val, 0.0f);
      res[e] = __float2bfloat16_rn(val);
    }
    *reinterpret_cast<uint4*>(out + (img + static_cast<size_t>(gy) * w + gx) * cout + n0 + v * 8) =
        *reinterpret_cast<const uint4*>(res);
  }
}

template <bool RELU, bool ROUND_SUM>
int launch(const void* x, const void* k, const void* b, void* out, int n, int h, int w, int cin,
           int cout, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel<RELU, ROUND_SUM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (w + kTW - 1) / kTW;
  const int tiles_h = (h + kTH - 1) / kTH;
  const dim3 grid(tiles_w * tiles_h, cout / kBN, n);
  conv3x3_kernel<RELU, ROUND_SUM><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), h, w, cin, cout,
      tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (see nu_cuda_error_string).
int nu_conv3x3(int device, const void* x, const void* k, const void* b, void* out, int n, int h,
               int w, int cin, int cout, int relu, int round_sum, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || cin < kKC || cin % kKC || cout < kBN ||
      cout % kBN || cout / kBN > 65535 ||
      static_cast<long long>((w + kTW - 1) / kTW) * ((h + kTH - 1) / kTH) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relu) {
    return round_sum ? launch<true, true>(x, k, b, out, n, h, w, cin, cout, s)
                     : launch<true, false>(x, k, b, out, n, h, w, cin, cout, s);
  }
  return round_sum ? launch<false, true>(x, k, b, out, n, h, w, cin, cout, s)
                   : launch<false, false>(x, k, b, out, n, h, w, cin, cout, s);
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
