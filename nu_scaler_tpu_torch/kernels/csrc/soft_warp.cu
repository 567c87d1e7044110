// Overlapped-tile (soft) motion-compensated blend of two frames, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel nu_scaler_tpu/kernels/soft_warp_pallas.py:984
// soft_warp_blend (-> _build :765 -> _kernel_strip_v7 :630; _kernel,
// _kernel_strip, _v5 and _v6 there are other TPU schedules of the same
// function).
//
// What it computes. Inputs: frames a and b, u8 RGBA [H, W]; per frame f
// (A, then B) the clipped tile motion tiles_f [Ty*Tx] (x, y), the candidate
// index of each tile assign_f [Ty*Tx] and K candidate offsets cand_y_f,
// cand_x_f; the blend weights w_A = 1 - t, w_B = t. Output pixel (r, c) lies
// in cell cy = (r + th/2) / th, local row lr = r + th/2 - cy*th (columns the
// same with tw); its four corner tiles are rows cy-1 | cy and columns
// cx-1 | cx, clamped to the tile grid, mixed with the bilinear weights of
// fy = (lr + 0.5)/th, fx = (lc + 0.5)/tw. Per frame, the corners' motion
// mixes into the smoothed motion (sm_y, sm_x); corner c with candidate
// k = assign[c] samples the frame bilinearly at (r + cand_y[k], c +
// cand_x[k]) and its +1 neighbours (edge-clamped) with fractions
// clip(sm - cand[k], 0, 1). out = rint(clip(w_A * sum_c bw_c * s_A,c +
// w_B * sum_c bw_c * s_B,c, 0, 255)), all four channels (alpha too).
//
// Every fp32 operation is rounded on its own (__fadd_rn, __fmul_rn,
// __fsub_rn: nvcc forms no FMA) and in the order of the plain PyTorch version
// in soft_warp_cuda.py, so the two agree bit for bit up to the library's own
// float behaviour. rintf rounds half to even, like jnp.round and torch.round.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32, published peaks): at
// 1080p the bytes that must move are a, b and out, 3 x 8.29 MB = 24.9 MB,
// about 7.4 us. The operations depend on the data: per pixel 126 fp32
// operations of cell and motion mixing, accumulation and packing, plus 42
// per distinct corner candidate of each frame (two fractions, three lerps on
// four channels): 210 (one candidate in every cell) to 462 (four) per pixel,
// 0.44 to 0.96 GFLOP at 1080p, 6.5 to 14.3 us. Where motion varies little,
// bytes bound the kernel; where neighbouring tiles differ, operations do.
// chip_smoke.py phase 5 measures it at 0.056 ms on the bench pair (13% of
// the bytes bound) and 0.080 ms on random motion (NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// Design (a first one, kept simple). One thread per output pixel; a block of
// 64 x 4 pixels. A block copies the 2 x 2 x K candidates into shared memory
// (the TPU kernel's scalar prefetch); each thread reads its four corners'
// motion and assignment through the read-only cache (the tile arrays are a
// few kB). Each tap is one 4-byte uchar4 load: a tile's offset is constant
// across its pixels, so the 32 threads of a warp read neighbouring addresses
// and the gathers coalesce through L1/L2. A corner whose candidate equals an
// earlier corner's reuses that sample (the same value, so the sum is
// unchanged). Not done yet: shared-memory slabs, cp.async, wider stores.
//
// C interface: nu_soft_warp_blend launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 64;
constexpr int kBlockY = 4;
constexpr int kMaxK = 8;

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  return make_float4(lerp_rn(a.x, b.x, f), lerp_rn(a.y, b.y, f),
                     lerp_rn(a.z, b.z, f), lerp_rn(a.w, b.w, f));
}

__device__ __forceinline__ float4 scale4(float s, float4 v) {
  return make_float4(__fmul_rn(s, v.x), __fmul_rn(s, v.y), __fmul_rn(s, v.z), __fmul_rn(s, v.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 load4(const uchar4* __restrict__ img, int idx) {
  const uchar4 p = __ldg(img + idx);
  return make_float4(static_cast<float>(p.x), static_cast<float>(p.y),
                     static_cast<float>(p.z), static_cast<float>(p.w));
}

__device__ __forceinline__ unsigned char pack_round(float v) {
  return static_cast<unsigned char>(rintf(fminf(fmaxf(v, 0.f), 255.f)));
}

// Bilinear sample of img at (r + dy, c + dx) with the +1 neighbours clamped
// to the frame, fractions clip(sm - d, 0, 1).
__device__ __forceinline__ float4 sample(const uchar4* __restrict__ img, int h, int w,
                                         int r, int c, int dy, int dx, float sm_y, float sm_x) {
  const float fyk = clamp01(__fsub_rn(sm_y, static_cast<float>(dy)));
  const float fxk = clamp01(__fsub_rn(sm_x, static_cast<float>(dx)));
  const int r0 = min(max(r + dy, 0), h - 1) * w;
  const int r1 = min(max(r + dy + 1, 0), h - 1) * w;
  const int c0 = min(max(c + dx, 0), w - 1);
  const int c1 = min(max(c + dx + 1, 0), w - 1);
  const float4 top = lerp4(load4(img, r0 + c0), load4(img, r0 + c1), fxk);
  const float4 bot = lerp4(load4(img, r1 + c0), load4(img, r1 + c1), fxk);
  return lerp4(top, bot, fyk);
}

__global__ void __launch_bounds__(kBlockX * kBlockY) soft_warp_kernel(
    const uchar4* __restrict__ a, const uchar4* __restrict__ b, int h, int w,
    const float2* __restrict__ tiles, const int* __restrict__ assign,
    const int* __restrict__ cand, int k, int th, int tw, float inv_th, float inv_tw,
    float w_a, float w_b, uchar4* __restrict__ out) {
  // cand layout [frame][y | x][k]
  __shared__ int s_cand[2 * 2 * kMaxK];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  if (tid < 4 * k) s_cand[tid] = cand[tid];
  __syncthreads();

  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= h || c >= w) return;

  const int ty = h / th;
  const int tx = w / tw;
  const int cy = (r + th / 2) / th;
  const int lr = r + th / 2 - cy * th;
  const int cx = (c + tw / 2) / tw;
  const int lc = c + tw / 2 - cx * tw;
  const int y0 = min(max(cy - 1, 0), ty - 1) * tx;
  const int y1 = min(max(cy, 0), ty - 1) * tx;
  const int x0 = min(max(cx - 1, 0), tx - 1);
  const int x1 = min(max(cx, 0), tx - 1);
  const int corner[4] = {y0 + x0, y0 + x1, y1 + x0, y1 + x1};

  const float fy = __fmul_rn(__fadd_rn(static_cast<float>(lr), 0.5f), inv_th);
  const float fx = __fmul_rn(__fadd_rn(static_cast<float>(lc), 0.5f), inv_tw);
  const float gy = __fsub_rn(1.f, fy);
  const float gx = __fsub_rn(1.f, fx);
  const float bw[4] = {__fmul_rn(gy, gx), __fmul_rn(gy, fx), __fmul_rn(fy, gx), __fmul_rn(fy, fx)};

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const uchar4* img = f ? b : a;
    const float2* tl = tiles + f * ty * tx;
    const int* asg = assign + f * ty * tx;
    const int* cand_y = s_cand + f * 2 * k;
    const int* cand_x = cand_y + k;

    float2 m[4];
    int kk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = __ldg(tl + corner[i]);
      kk[i] = __ldg(asg + corner[i]);
    }
    const float sm_y = __fadd_rn(
        __fmul_rn(gy, __fadd_rn(__fmul_rn(gx, m[0].y), __fmul_rn(fx, m[1].y))),
        __fmul_rn(fy, __fadd_rn(__fmul_rn(gx, m[2].y), __fmul_rn(fx, m[3].y))));
    const float sm_x = __fadd_rn(
        __fmul_rn(gy, __fadd_rn(__fmul_rn(gx, m[0].x), __fmul_rn(fx, m[1].x))),
        __fmul_rn(fy, __fadd_rn(__fmul_rn(gx, m[2].x), __fmul_rn(fx, m[3].x))));

    // one sample per distinct candidate among the four corners
#define NU_SAMPLE(i) sample(img, h, w, r, c, cand_y[kk[i]], cand_x[kk[i]], sm_y, sm_x)
    const float4 s0 = NU_SAMPLE(0);
    const float4 s1 = kk[1] == kk[0] ? s0 : NU_SAMPLE(1);
    const float4 s2 = kk[2] == kk[0] ? s0 : kk[2] == kk[1] ? s1 : NU_SAMPLE(2);
    const float4 s3 = kk[3] == kk[0]   ? s0
                      : kk[3] == kk[1] ? s1
                      : kk[3] == kk[2] ? s2
                                       : NU_SAMPLE(3);
#undef NU_SAMPLE
    float4 v = scale4(bw[0], s0);
    v = add4(v, scale4(bw[1], s1));
    v = add4(v, scale4(bw[2], s2));
    v = add4(v, scale4(bw[3], s3));
    acc = f == 0 ? scale4(w_a, v) : add4(acc, scale4(w_b, v));
  }
  out[static_cast<size_t>(r) * w + c] =
      make_uchar4(pack_round(acc.x), pack_round(acc.y), pack_round(acc.z), pack_round(acc.w));
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (see nu_cuda_error_string).
int nu_soft_warp_blend(int device, const void* a, const void* b, int h, int w,
                       const void* tiles, const void* assign, const void* cand, int k,
                       int th, int tw, float inv_th, float inv_tw, float w_a, float w_b,
                       void* out, void* stream) {
  if (k < 1 || k > kMaxK || th < 1 || tw < 1 || h % th != 0 || w % tw != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  soft_warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uchar4*>(a), static_cast<const uchar4*>(b), h, w,
      static_cast<const float2*>(tiles), static_cast<const int*>(assign),
      static_cast<const int*>(cand), k, th, tw, inv_th, inv_tw, w_a, w_b,
      static_cast<uchar4*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
