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
// Wv and Wh are the compact per-axis tap tables of resample_cuda.ResamplePlan:
// output row o reads the K consecutive inputs first[o] .. first[o] + K - 1
// with weights w[o, 0..K-1]. Each output sums its taps in ascending order
// with fmaf from 0, in the order resample_fused.cu sums them, so the two
// kernels give the same bytes: the fp32 intermediate that the fused kernel
// keeps in shared memory is here written to and read back from device memory
// unchanged.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. At 1080p->4K the frame
// in and out are 41.5 MB (0.0124 ms); the fp32 intermediate, 2160 x 1920 x 16
// bytes = 66.4 MB written once and read once, makes it 174 MB (0.0520 ms).
// The TPU kernel's banded weight blocks, kron(W, I4) lane expansion and
// /255 domain are not carried over: one thread per output pixel reads its
// taps directly, neighbouring threads on neighbouring pixels.
//
// C interface: nu_resample_vert and nu_resample_horiz each launch on the
// caller's stream, allocate nothing and return cudaGetLastError() of the
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned char pack_trunc(float v) {
  return static_cast<unsigned char>(truncf(fminf(fmaxf(v, 0.f), 255.f)));
}

// grid: (column blocks, OH, N); one thread per intermediate pixel.
__global__ void __launch_bounds__(kThreads) vert_kernel(
    const uchar4* __restrict__ src, int h, int w,
    const int* __restrict__ first_v, const float* __restrict__ w_v, int kv, int oh,
    float4* __restrict__ mid) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= w) return;
  const int oy = blockIdx.y;
  const uchar4* col = src + (static_cast<size_t>(blockIdx.z) * h + __ldg(first_v + oy)) * w + x;
  const float* wr = w_v + static_cast<size_t>(oy) * kv;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < kv; ++k) {
    const float wk = __ldg(wr + k);
    const uchar4 p = __ldg(col + static_cast<size_t>(k) * w);
    acc.x = fmaf(wk, static_cast<float>(p.x), acc.x);
    acc.y = fmaf(wk, static_cast<float>(p.y), acc.y);
    acc.z = fmaf(wk, static_cast<float>(p.z), acc.z);
    acc.w = fmaf(wk, static_cast<float>(p.w), acc.w);
  }
  mid[(static_cast<size_t>(blockIdx.z) * oh + oy) * w + x] = acc;
}

// grid: (column blocks, OH, N); one thread per output pixel.
__global__ void __launch_bounds__(kThreads) horiz_kernel(
    const float4* __restrict__ mid, int w, int oh,
    const int* __restrict__ first_h, const float* __restrict__ w_h, int kh, int ow,
    uchar4* __restrict__ dst) {
  const int ox = blockIdx.x * kThreads + threadIdx.x;
  if (ox >= ow) return;
  const size_t row = static_cast<size_t>(blockIdx.z) * oh + blockIdx.y;
  const float4* in = mid + row * w + __ldg(first_h + ox);
  const float* wr = w_h + static_cast<size_t>(ox) * kh;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < kh; ++k) {
    const float wk = __ldg(wr + k);
    const float4 p = __ldg(in + k);
    acc.x = fmaf(wk, p.x, acc.x);
    acc.y = fmaf(wk, p.y, acc.y);
    acc.z = fmaf(wk, p.z, acc.z);
    acc.w = fmaf(wk, p.w, acc.w);
  }
  dst[row * ow + ox] = make_uchar4(pack_trunc(acc.x), pack_trunc(acc.y), pack_trunc(acc.z),
                                   pack_trunc(acc.w));
}

bool bad_grid(int n, int rows, int cols) {
  return n < 1 || n > 65535 || rows < 1 || rows > 65535 || cols < 1;
}

}  // namespace

extern "C" {

// Launch 1: u8 src [n, h, w, 4] -> fp32 mid [n, oh, w, 4]. Returns 0 on
// success, else a cudaError_t code (see nu_cuda_error_string).
int nu_resample_vert(int device, const void* src, int n, int h, int w,
                     const void* first_v, const void* w_v, int kv, int oh,
                     void* mid, void* stream) {
  if (bad_grid(n, oh, w) || h < 1 || kv < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + kThreads - 1) / kThreads, oh, n);
  vert_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uchar4*>(src), h, w, static_cast<const int*>(first_v),
      static_cast<const float*>(w_v), kv, oh, static_cast<float4*>(mid));
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: fp32 mid [n, oh, w, 4] -> u8 dst [n, oh, ow, 4].
int nu_resample_horiz(int device, const void* mid, int n, int oh, int w,
                      const void* first_h, const void* w_h, int kh, int ow,
                      void* dst, void* stream) {
  if (bad_grid(n, oh, ow) || w < 1 || kh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((ow + kThreads - 1) / kThreads, oh, n);
  horiz_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(mid), w, oh, static_cast<const int*>(first_h),
      static_cast<const float*>(w_h), kh, ow, static_cast<uchar4*>(dst));
  return static_cast<int>(cudaGetLastError());
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
