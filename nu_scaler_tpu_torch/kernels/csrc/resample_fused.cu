// Fused separable resample for Hopper (sm_90a), with an optional batch and an
// optional cross-fade epilogue.
//
// Replaces three TPU kernels of nu_scaler_tpu/kernels/resample_pallas.py:
//   make_pallas_fused          (_fused_kernel)          -> NT = 0, N = 1
//   make_pallas_fused_batched  (_fused_kernel_batched)  -> NT = 0, N > 1
//   make_pallas_fused_blend    (_fused_blend_kernel)    -> NT = 1 or 2
//
// What it computes, per channel (alpha included), on raw 0..255 samples:
//   cur = trunc(clip(Wv . X . Wh^T, 0, 255))                        (u8)
//   mid_t = clip(rint(prev + (cur - prev) * t), 0, 255)  for each t  (u8)
// Wv and Wh are given as compact per-axis tap tables: output row o reads the
// K consecutive inputs first[o] .. first[o] + K - 1 with weights w[o, 0..K-1]
// (zero-padded). `first` is non-decreasing, so an output tile's input
// footprint is one contiguous rectangle.
//
// Design. One block per output tile (grid: column tiles, row tiles, batch).
// The block copies the tile's input footprint into shared memory, runs the
// vertical pass in fp32 into a shared-memory intermediate, then the
// horizontal pass in fp32, and writes u8. The fp32 intermediate never goes to
// device memory, which is what the TPU kernel was built for. At 1080p->4K the
// work is bound by bytes (41.5 MB per frame against ~0.75 GFLOP of fp32 FMA),
// so the kernel reads each input byte from device memory about once and
// writes each output byte once. The TPU-only pieces (banded weight blocks,
// bf16 hi/lo weight split, padded 2-D output) are not carried over: this is
// fp32 throughout, with no tensor cores.
//
// Rounding. The cross-fade is two separately rounded fp32 operations, as in
// the TPU kernel (a + (b - a) * t); __fmul_rn / __fadd_rn keep nvcc from
// contracting them into an FMA, which would move ties at t = 1/3 and 2/3.
// rintf rounds half to even, like jnp.round and torch.round.
//
// C interface: nu_resample_fused launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned char pack_trunc(float v) {
  return static_cast<unsigned char>(truncf(fminf(fmaxf(v, 0.f), 255.f)));
}

__device__ __forceinline__ unsigned char mix_round(unsigned char a, unsigned char b, float t) {
  const float fa = static_cast<float>(a);
  const float m = __fadd_rn(fa, __fmul_rn(__fsub_rn(static_cast<float>(b), fa), t));
  return static_cast<unsigned char>(fminf(fmaxf(rintf(m), 0.f), 255.f));
}

__device__ __forceinline__ uchar4 mix4(uchar4 a, uchar4 b, float t) {
  return make_uchar4(mix_round(a.x, b.x, t), mix_round(a.y, b.y, t),
                     mix_round(a.z, b.z, t), mix_round(a.w, b.w, t));
}

// NT: number of cross-fade outputs (0, 1 or 2).
template <int NT>
__global__ void __launch_bounds__(kThreads) resample_fused_kernel(
    const uchar4* __restrict__ src, int h, int w,
    const int* __restrict__ first_v, const float* __restrict__ w_v, int kv,
    const int* __restrict__ first_h, const float* __restrict__ w_h, int kh,
    int oh, int ow, int tile_h, int tile_w,
    const uchar4* __restrict__ prev, float t0, float t1,
    uchar4* __restrict__ dst, uchar4* __restrict__ mid0, uchar4* __restrict__ mid1) {
  extern __shared__ float4 smem[];

  const int ox0 = blockIdx.x * tile_w;
  const int oy0 = blockIdx.y * tile_h;
  const int th = min(tile_h, oh - oy0);
  const int tw = min(tile_w, ow - ox0);

  // Input footprint of this tile: rows r0 .. r0 + fr - 1, cols c0 .. c0 + fc - 1.
  const int r0 = first_v[oy0];
  const int fr = first_v[oy0 + th - 1] + kv - r0;
  const int c0 = first_h[ox0];
  const int fc = first_h[ox0 + tw - 1] + kh - c0;

  // Layout: fp32 intermediate [th][fc] (float4 per pixel), then the u8
  // footprint [fr][fc] (uchar4 per pixel). The host sized the buffer for the
  // largest tile.
  float4* inter = smem;
  uchar4* foot = reinterpret_cast<uchar4*>(smem + tile_h * fc);

  const uchar4* img = src + static_cast<size_t>(blockIdx.z) * h * w;
  for (int i = threadIdx.x; i < fr * fc; i += kThreads) {
    const int r = i / fc;
    const int c = i - r * fc;
    foot[i] = img[static_cast<size_t>(r0 + r) * w + (c0 + c)];
  }
  __syncthreads();

  // Vertical pass: inter[r][c] = sum_k w_v[oy, k] * foot[first_v[oy] - r0 + k][c].
  for (int i = threadIdx.x; i < th * fc; i += kThreads) {
    const int r = i / fc;
    const int c = i - r * fc;
    const int oy = oy0 + r;
    const float* wr = w_v + static_cast<size_t>(oy) * kv;
    const uchar4* col = foot + (first_v[oy] - r0) * fc + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < kv; ++k) {
      const float wk = __ldg(wr + k);
      const uchar4 p = col[k * fc];
      acc.x = fmaf(wk, static_cast<float>(p.x), acc.x);
      acc.y = fmaf(wk, static_cast<float>(p.y), acc.y);
      acc.z = fmaf(wk, static_cast<float>(p.z), acc.z);
      acc.w = fmaf(wk, static_cast<float>(p.w), acc.w);
    }
    inter[i] = acc;
  }
  __syncthreads();

  // Horizontal pass, trunc pack and the cross-fade epilogue.
  const size_t plane = static_cast<size_t>(blockIdx.z) * oh * ow;
  for (int i = threadIdx.x; i < th * tw; i += kThreads) {
    const int r = i / tw;
    const int x = i - r * tw;
    const int ox = ox0 + x;
    const float* wr = w_h + static_cast<size_t>(ox) * kh;
    const float4* row = inter + r * fc + (first_h[ox] - c0);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < kh; ++k) {
      const float wk = __ldg(wr + k);
      const float4 p = row[k];
      acc.x = fmaf(wk, p.x, acc.x);
      acc.y = fmaf(wk, p.y, acc.y);
      acc.z = fmaf(wk, p.z, acc.z);
      acc.w = fmaf(wk, p.w, acc.w);
    }
    const uchar4 cur = make_uchar4(pack_trunc(acc.x), pack_trunc(acc.y),
                                   pack_trunc(acc.z), pack_trunc(acc.w));
    const size_t o = plane + static_cast<size_t>(oy0 + r) * ow + ox;
    dst[o] = cur;
    if constexpr (NT > 0) {
      const uchar4 a = prev[o];
      mid0[o] = mix4(a, cur, t0);
      if constexpr (NT > 1) {
        mid1[o] = mix4(a, cur, t1);
      }
    }
  }
}

template <int NT>
int launch(const void* src, int n, int h, int w,
           const void* first_v, const void* w_v, int kv,
           const void* first_h, const void* w_h, int kh,
           int oh, int ow, int tile_h, int tile_w, int smem_bytes,
           const void* prev, float t0, float t1,
           void* dst, void* mid0, void* mid1, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resample_fused_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((ow + tile_w - 1) / tile_w, (oh + tile_h - 1) / tile_h, n);
  resample_fused_kernel<NT><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const uchar4*>(src), h, w,
      static_cast<const int*>(first_v), static_cast<const float*>(w_v), kv,
      static_cast<const int*>(first_h), static_cast<const float*>(w_h), kh,
      oh, ow, tile_h, tile_w,
      static_cast<const uchar4*>(prev), t0, t1,
      static_cast<uchar4*>(dst), static_cast<uchar4*>(mid0), static_cast<uchar4*>(mid1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (see nu_cuda_error_string).
int nu_resample_fused(int device, const void* src, int n, int h, int w,
                      const void* first_v, const void* w_v, int kv,
                      const void* first_h, const void* w_h, int kh,
                      int oh, int ow, int tile_h, int tile_w, int smem_bytes,
                      const void* prev, int n_ts, float t0, float t1,
                      void* dst, void* mid0, void* mid1, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_ts) {
    case 0:
      return launch<0>(src, n, h, w, first_v, w_v, kv, first_h, w_h, kh, oh, ow,
                       tile_h, tile_w, smem_bytes, prev, t0, t1, dst, mid0, mid1, s);
    case 1:
      return launch<1>(src, n, h, w, first_v, w_v, kv, first_h, w_h, kh, oh, ow,
                       tile_h, tile_w, smem_bytes, prev, t0, t1, dst, mid0, mid1, s);
    case 2:
      return launch<2>(src, n, h, w, first_v, w_v, kv, first_h, w_h, kh, oh, ow,
                       tile_h, tile_w, smem_bytes, prev, t0, t1, dst, mid0, mid1, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
