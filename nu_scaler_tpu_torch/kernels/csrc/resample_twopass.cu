// Separable resample in two launches, for Hopper (sm_90a): a vertical pass
// that writes its fp32 intermediate to device memory, then a horizontal pass
// that packs to u8.
//
// Replaces the TPU kernel nu_scaler_tpu/kernels/resample_pallas.py:65
// make_pallas_resampler (-> _vert_kernel :31, _horiz_kernel :44).
//
// What it computes, per channel (alpha included), on raw 0..255 samples, the
// function of resample_fused.cu with NT = 0:
//   mid = Wv . X               fp32 [N, OH, W, 4]      (launch 1, vertical)
//   out = trunc(clip(mid . Wh^T, 0, 255))   u8 [N, OH, OW, 4]  (launch 2)
// Each output sums its taps in ascending order with fmaf from +0, in the
// order resample_fused.cu sums them, so the two kernels give the same bytes:
// the fp32 intermediate that the fused kernel keeps in shared memory is here
// written to and read back from device memory unchanged.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. At 1080p->4K the frame
// in and out are 41.5 MB (0.0124 ms); the fp32 intermediate, 2160 x 1920 x 16
// bytes = 66.4 MB written once and read once, makes it 174 MB (0.0520 ms):
// 0.0223 ms for the vertical launch, 0.0297 for the horizontal one.
//
// Design (resample_fused.cu's machinery, PR 11, without its tiles):
//  * The tap tables come as dense bands, built once per plan on the host
//    (resample_cuda.twopass_bands): for each run of 8 output rows, the weight
//    of every input row of the run's window (wv rows from first_v[8 r]) for
//    each of the 8 rows, zero outside a row's band; for each group of 4
//    output columns the same over the group's window of wh intermediate
//    columns from first_h[4 g], a float4 per window column, stored [wh,
//    groups] so that neighbouring threads read neighbouring float4s. A
//    zero-weight fmaf adds +0 to a sum that is never -0 (the inputs are
//    >= 0 and the chains start at +0), so the dense chains give every output
//    exactly the chain of its own taps, in order. A window row or column
//    past the frame has zero weight and is read at the last row or column.
//  * Vertical pass: a thread owns one intermediate column of a run of 8
//    rows: it reads each input of the run's window once (4 bytes, the
//    neighbouring threads on the neighbouring columns), turns it into 4
//    floats without an I2F (the byte under 2^23's exponent, minus 2^23:
//    exact), adds it into 8 float4 sums (32 FMAs; the weights are the same
//    for the whole block, read as two float4s a row through L1), and stores
//    a float4 a row.
//  * Horizontal pass: a thread owns 4 neighbouring outputs in each of two
//    rows: per window column one float4 of weights and two of the
//    intermediate for 32 FMAs. The trunc pack is __fadd_rz(v, 2^23) of the
//    clamped sum (no F2I); the 4 pixels are packed with byte permutes and
//    stored as 16 bytes where the row's length allows it.
//
// C interface: nu_resample_vert and nu_resample_horiz each launch on the
// caller's stream, allocate nothing and return cudaGetLastError() of the
// launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRB = 8;                // output rows of a vertical work item
constexpr int kGW = 4;                // output columns of a horizontal work item
constexpr int kHR = 2;                // rows of a horizontal work item
constexpr float kMagic = 8388608.0f;  // 2^23: its float's low mantissa byte is an integer 0..255

// byte i of px as an exact float: 2^23 + byte, minus 2^23
__device__ __forceinline__ float byte_to_float(uint32_t px, uint32_t i) {
  return __fsub_rn(__uint_as_float(__byte_perm(px, 0x4B000000u, 0x7440u | i)), kMagic);
}

__device__ __forceinline__ float4 unpack(uint32_t px) {
  return make_float4(byte_to_float(px, 0), byte_to_float(px, 1), byte_to_float(px, 2),
                     byte_to_float(px, 3));
}

__device__ __forceinline__ float4 fma4(float wk, float4 v, float4 acc) {
  return make_float4(fmaf(wk, v.x, acc.x), fmaf(wk, v.y, acc.y), fmaf(wk, v.z, acc.z),
                     fmaf(wk, v.w, acc.w));
}

// the bits of 2^23 + trunc(clip(v, 0, 255)): its low byte is the packed value
__device__ __forceinline__ uint32_t trunc_bits(float v) {
  return __float_as_uint(__fadd_rz(fminf(fmaxf(v, 0.f), 255.f), kMagic));
}

// the low bytes of four words -> one RGBA word
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u), 0x5410u);
}

__device__ __forceinline__ uint32_t pack_trunc(float4 v) {
  return pack_low_bytes(trunc_bits(v.x), trunc_bits(v.y), trunc_bits(v.z), trunc_bits(v.w));
}

// grid: (column blocks, runs of 8 rows, N); one thread per intermediate
// column of a run.
__global__ void __launch_bounds__(kThreads) vert_kernel(
    const uint32_t* __restrict__ src, int h, int w, const int* __restrict__ first_v,
    const float4* __restrict__ dv, int wv, int oh, float4* __restrict__ mid) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= w) return;
  const int r = blockIdx.y;
  const int row0 = __ldg(first_v + r * kRB);
  const uint32_t* col = src + static_cast<size_t>(blockIdx.z) * h * w + x;
  const float4* wr = dv + static_cast<size_t>(r) * wv * 2;  // [wv][8] weights as 2 float4s a row
  float4 acc[kRB];
#pragma unroll
  for (int e = 0; e < kRB; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < wv; ++j) {
    const int row = min(row0 + j, h - 1);  // past the frame: a zero weight
    const float4 v = unpack(__ldg(col + static_cast<size_t>(row) * w));
    const float4 wa = __ldg(wr + 2 * j), wb = __ldg(wr + 2 * j + 1);
    acc[0] = fma4(wa.x, v, acc[0]);
    acc[1] = fma4(wa.y, v, acc[1]);
    acc[2] = fma4(wa.z, v, acc[2]);
    acc[3] = fma4(wa.w, v, acc[3]);
    acc[4] = fma4(wb.x, v, acc[4]);
    acc[5] = fma4(wb.y, v, acc[5]);
    acc[6] = fma4(wb.z, v, acc[6]);
    acc[7] = fma4(wb.w, v, acc[7]);
  }
  float4* out = mid + (static_cast<size_t>(blockIdx.z) * oh + r * kRB) * w + x;
#pragma unroll
  for (int e = 0; e < kRB; ++e) {
    if (r * kRB + e < oh) out[static_cast<size_t>(e) * w] = acc[e];
  }
}

// grid: (group blocks, pairs of rows, N); one thread per group of 4 output
// columns in two rows.
__global__ void __launch_bounds__(kThreads) horiz_kernel(
    const float4* __restrict__ mid, int w, int oh, const int* __restrict__ first_h,
    const float4* __restrict__ dh, int wh, int ow, uint32_t* __restrict__ dst) {
  const int groups = (ow + kGW - 1) / kGW;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  const int y0 = blockIdx.y * kHR;
  const bool two = y0 + 1 < oh;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * oh + y0;
  const int c0 = __ldg(first_h + g * kGW);
  const float4* in0 = mid + row0 * w;
  const float4* in1 = two ? in0 + w : in0;
  float4 a0[kGW], a1[kGW];
#pragma unroll
  for (int e = 0; e < kGW; ++e) {
    a0[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    a1[e] = a0[e];
  }
  for (int j = 0; j < wh; ++j) {
    const int c = min(c0 + j, w - 1);  // past the frame: a zero weight
    const float4 wk = __ldg(dh + static_cast<size_t>(j) * groups + g);
    const float4 v0 = __ldg(in0 + c), v1 = __ldg(in1 + c);
    a0[0] = fma4(wk.x, v0, a0[0]);
    a0[1] = fma4(wk.y, v0, a0[1]);
    a0[2] = fma4(wk.z, v0, a0[2]);
    a0[3] = fma4(wk.w, v0, a0[3]);
    a1[0] = fma4(wk.x, v1, a1[0]);
    a1[1] = fma4(wk.y, v1, a1[1]);
    a1[2] = fma4(wk.z, v1, a1[2]);
    a1[3] = fma4(wk.w, v1, a1[3]);
  }
  const uint4 p0 = make_uint4(pack_trunc(a0[0]), pack_trunc(a0[1]), pack_trunc(a0[2]), pack_trunc(a0[3]));
  const uint4 p1 = make_uint4(pack_trunc(a1[0]), pack_trunc(a1[1]), pack_trunc(a1[2]), pack_trunc(a1[3]));
  uint32_t* d0 = dst + row0 * ow + g * kGW;
  if (ow % kGW == 0) {  // rows of whole 16-byte groups
    *reinterpret_cast<uint4*>(d0) = p0;
    if (two) *reinterpret_cast<uint4*>(d0 + ow) = p1;
    return;
  }
  const uint32_t q0[kGW] = {p0.x, p0.y, p0.z, p0.w}, q1[kGW] = {p1.x, p1.y, p1.z, p1.w};
#pragma unroll
  for (int e = 0; e < kGW; ++e) {
    if (g * kGW + e >= ow) break;
    d0[e] = q0[e];
    if (two) d0[ow + e] = q1[e];
  }
}

bool bad_grid(int n, int rows, int cols) {
  return n < 1 || n > 65535 || rows < 1 || rows > 65535 || cols < 1;
}

}  // namespace

extern "C" {

// Launch 1: u8 src [n, h, w, 4] -> fp32 mid [n, oh, w, 4]; dv: the vertical
// bands, fp32 [ceil(oh / 8), wv, 8]. Returns 0 on success, else a
// cudaError_t code (see nu_cuda_error_string).
int nu_resample_vert(int device, const void* src, int n, int h, int w,
                     const void* first_v, const void* dv, int wv, int oh,
                     void* mid, void* stream) {
  const int runs = (oh + kRB - 1) / kRB;
  if (bad_grid(n, runs, w) || h < 1 || wv < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const dim3 grid((w + kThreads - 1) / kThreads, runs, n);
  vert_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), h, w, static_cast<const int*>(first_v),
      static_cast<const float4*>(dv), wv, oh, static_cast<float4*>(mid));
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: fp32 mid [n, oh, w, 4] -> u8 dst [n, oh, ow, 4]; dh: the
// horizontal bands, fp32 [wh, ceil(ow / 4), 4].
int nu_resample_horiz(int device, const void* mid, int n, int oh, int w,
                      const void* first_h, const void* dh, int wh, int ow,
                      void* dst, void* stream) {
  const int pairs = (oh + kHR - 1) / kHR;
  if (bad_grid(n, pairs, ow) || w < 1 || wh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const int groups = (ow + kGW - 1) / kGW;
  const dim3 grid((groups + kThreads - 1) / kThreads, pairs, n);
  horiz_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(mid), w, oh, static_cast<const int*>(first_h),
      static_cast<const float4*>(dh), wh, ow, static_cast<uint32_t*>(dst));
  return static_cast<int>(cudaGetLastError());
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
