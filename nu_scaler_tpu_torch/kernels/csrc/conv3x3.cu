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
// shared memory), with hand-written PTX. The device code lives in
// conv3x3_core.cuh, which trunk_fused.cu shares: its design notes say how
// the halo, the A fragments and the weight ring work.
//  * A block of 256 threads (two warpgroups) owns a 16 x 16 tile of
//    output positions and 128 output channels; one block per SM. Grid:
//    x = spatial tiles, y = Cout / 128, z = batch. It runs the header's main
//    loop (conv_tile) once and its epilogue (stage_tile), then writes the
//    staged tile with 16-byte stores, masked at the right and bottom edges.
//  * Every block reads the 9*Cin*128 weights of its channel tile through L2
//    once per 256 positions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "conv3x3_core.cuh"
#include "device_guard.cuh"

namespace {

using namespace nu_conv;

template <int TH, int TW, int NS, bool RELU, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ kp,
               const void* __restrict__ b, const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int h, int w, int cin, int cout, int tiles_w) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t halo = (raw + 1023u) & ~1023u;
  unsigned char* stage_out = smem_raw + (halo - raw);

  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * kBN;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;

  float acc[2][64];
  conv_tile<TH, TW, NS>(halo, x + img * cin, kp, h, w, cin, y0, x0, n0, acc);
  stage_tile<RELU, EPI>(acc, stage_out, b, scale, n0);
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

bool bad_shape(int n, int h, int w, int cin, int cout, int tile_w) {
  return n < 1 || n > 65535 || h < 1 || w < 1 || cin < kKC || cin % kKC || cout < kBN ||
         cout % kBN || cout / kBN > 65535 ||
         static_cast<long long>((w + tile_w - 1) / tile_w) *
                 ((h + kBM / tile_w - 1) / (kBM / tile_w)) >
             0x7fffffffLL;
}

}  // namespace

extern "C" {

// The conv at the kernel's one tile: 16 x 16 positions, a ring of 4 weight
// stages. Returns 0 on success, else a cudaError_t code (see
// nu_cuda_error_string).
int nu_conv3x3(int device, const void* x, const void* k, const void* b, void* out, int n, int h,
               int w, int cin, int cout, int relu, int round_sum, void* stream) {
  if (bad_shape(n, h, w, cin, cout, 16)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relu) {
    return round_sum ? launch<16, 16, 4, true, kRoundSum>(x, k, b, nullptr, out, n, h, w, cin, cout, s)
                     : launch<16, 16, 4, true, kSingle>(x, k, b, nullptr, out, n, h, w, cin, cout, s);
  }
  return round_sum ? launch<16, 16, 4, false, kRoundSum>(x, k, b, nullptr, out, n, h, w, cin, cout, s)
                   : launch<16, 16, 4, false, kSingle>(x, k, b, nullptr, out, n, h, w, cin, cout, s);
}

// The int8-grid mode at the default tile: x and k integer-valued bf16,
// scale fp32 [cout], b fp32 [cout] or NULL (no bias).
int nu_conv3x3_q(int device, const void* x, const void* k, const float* scale, const float* b,
                 void* out, int n, int h, int w, int cin, int cout, int relu, void* stream) {
  if (scale == nullptr || bad_shape(n, h, w, cin, cout, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? launch<16, 16, 4, true, kQGrid>(x, k, b, scale, out, n, h, w, cin, cout, s)
              : launch<16, 16, 4, false, kQGrid>(x, k, b, scale, out, n, h, w, cin, cout, s);
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
