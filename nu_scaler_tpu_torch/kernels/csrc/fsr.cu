// Fused FSR upscale (EASU + RCAS) for integer scales, for Hopper (sm_90a).
//
// Replaces the TPU kernels nu_scaler_tpu/kernels/fsr_pallas.py:207
// make_fsr_phase_kernel (-> _make_kernel :65) and :246
// make_fsr_phase_kernel_batched: one kernel, the batch on blockIdx.z.
//
// What it computes (the function of fsr_cuda.fsr_plain, in its fp32 order).
// Input u8 RGBA [N, H, W], scaled by f32(1/255) on load; output u8 RGBA
// [N, S*H, S*W], alpha 255. Indices are clamped to the image, which is the
// TPU side's edge padding.
//  * EASU at every input pixel: vgx = (1/3)*sum_c |up - down|, vgy =
//    (1/3)*sum_c |left - right|; ax = vgx + 1e-4, ay = vgy + 1e-4; norm =
//    sqrt(ax*ax + ay*ay); dir = (ax, ay) / norm; wx = |dirx| / (|dirx| +
//    |diry|), wy = 1 - wx. For each phase (py, px), offs = ((px + 0.5)/S)*wx
//    + ((py + 0.5)/S)*wy; the 16 taps (rows -1..+2, columns -1..+2) weigh
//    FsrCubic(|tx*wx + ty*wy - offs|), summed taps outer, phases inner; col =
//    sum_c / max(sum_w, 1e-4), then col + (centre - col)*sharp when the
//    host says sharp > 1e-3; luma = 0.299 r + 0.587 g + 0.114 b.
//  * RCAS at every output pixel of the interleaved image, on its four raster
//    neighbours (another phase of the same or an adjacent input pixel; at the
//    output image's edge, the centre itself): t = clip((max_l - min_l)*5, 0,
//    1), strength = sharp*(1 - t*t*(3 - 2t)), out = c + (4c - top - bottom -
//    left - right)*strength, packed as truncf(clip(out, 0, 1)*255).
//
// Every fp32 operation is rounded on its own (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn, __fsqrt_rn: nvcc forms no FMA) in the plain version's
// order. FsrCubic jumps from 1 to 0 at d = 2, and RCAS amplifies a changed
// EASU value, so a single contracted multiply-add would move an output by
// several LSB where a distance lies within an ulp of 2.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32, published peaks).
// At 1080p -> 4K (S = 2) the bytes are 8.29 MB in and 33.18 MB out, 12.4 us.
// The fp32 operations per input pixel are 79 + 373*S*S for EASU (direction
// 31; per tap 3; per tap and phase 22: distance 2, cubic 13, accumulation 7;
// per phase 3 for offs and 18 to normalise, mix and take luma; 9 fewer per
// phase without the mix) and 51 per output pixel for RCAS: 3.68 GFLOP at
// 1080p -> 4K, 55 us. So operations bound it, by 4x.
//
// Design (a first one, kept simple). A block of 256 threads owns a 16 x 16
// tile of input pixels. It loads the tile with a halo of 2 above and left and
// 3 below and right (the EASU taps of the tile and its one-pixel ring) into
// shared memory as planar fp32, computes EASU for the 18 x 18 ringed pixels
// in all S*S phases into shared memory as (r, g, b, luma), and after a
// barrier runs RCAS for its (16 S)^2 output pixels, each written as one
// 4-byte store, neighbouring threads on neighbouring pixels. The ring costs
// 27% more EASU work than the tile needs. Shared memory is S*S*18*18*16 +
// 3*21*21*4 bytes: 26 KB at S = 2, 52 KB at S = 3, 88 KB at S = 4 (above
// 48 KB only with the dynamic shared-memory attribute, set per launch). Not
// done yet: more pixels per thread, wider stores, a smaller ring.
//
// C interface: nu_fsr launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;         // input pixels per block side
constexpr int kRing = kTile + 2;  // EASU region: the tile and a 1-pixel ring
constexpr int kIn = kTile + 5;    // input region: rows / columns -2 .. kTile + 2
constexpr int kThreads = 256;
constexpr int kMaxScale = 4;

constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kThird = 1.0f / 3.0f;
constexpr float kEps = 1e-4f;

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// FsrCubic on d >= 0: 2 - 1.5d - 0.5d^3 + d^2 to 1, -0.5d + 2.5d^2 - d^3 to 2.
__device__ __forceinline__ float fsr_cubic(float d) {
  const float d2 = __fmul_rn(d, d);
  const float d3 = __fmul_rn(d2, d);
  if (d <= 1.f) {
    return __fadd_rn(__fsub_rn(__fsub_rn(2.f, __fmul_rn(1.5f, d)), __fmul_rn(0.5f, d3)), d2);
  }
  if (d <= 2.f) return __fsub_rn(__fadd_rn(__fmul_rn(-0.5f, d), __fmul_rn(2.5f, d2)), d3);
  return 0.f;
}

__device__ __forceinline__ float abs_diff_sum3(const float* p, int a, int b) {
  constexpr int kPlane = kIn * kIn;
  const float s0 = fabsf(__fsub_rn(p[a], p[b]));
  const float s1 = fabsf(__fsub_rn(p[kPlane + a], p[kPlane + b]));
  const float s2 = fabsf(__fsub_rn(p[2 * kPlane + a], p[2 * kPlane + b]));
  return __fmul_rn(__fadd_rn(__fadd_rn(s0, s1), s2), kThird);
}

__device__ __forceinline__ unsigned char pack_trunc(float v) {
  return static_cast<unsigned char>(truncf(__fmul_rn(clamp01(v), 255.f)));
}

template <int S>
__global__ void __launch_bounds__(kThreads)
    fsr_kernel(const uchar4* __restrict__ src, int h, int w, float sharp, int mix,
               uchar4* __restrict__ dst) {
  constexpr int kPh = S * S;
  constexpr int kRingPx = kRing * kRing;
  constexpr int kPlane = kIn * kIn;
  constexpr int kOut = S * kTile;  // output pixels per block side
  extern __shared__ float4 smem[];
  float4* s_e = smem;                                         // [kPh][kRing][kRing]
  float* s_in = reinterpret_cast<float*>(smem + kPh * kRingPx);  // [3][kIn][kIn]

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const uchar4* img = src + static_cast<size_t>(n) * h * w;
  const int tid = threadIdx.x;

  // 1. the input region, edge-clamped, planar fp32 in [0, 1]
  for (int i = tid; i < kPlane; i += kThreads) {
    const int iy = i / kIn;
    const int ix = i - iy * kIn;
    const int gy = min(max(y0 - 2 + iy, 0), h - 1);
    const int gx = min(max(x0 - 2 + ix, 0), w - 1);
    const uchar4 p = __ldg(img + static_cast<size_t>(gy) * w + gx);
    s_in[i] = __fmul_rn(static_cast<float>(p.x), kInv255);
    s_in[kPlane + i] = __fmul_rn(static_cast<float>(p.y), kInv255);
    s_in[2 * kPlane + i] = __fmul_rn(static_cast<float>(p.z), kInv255);
  }
  __syncthreads();

  // 2. EASU of the tile and its ring, all phases; ringed pixel (ry, rx) is
  //    input (y0 - 1 + ry, x0 - 1 + rx), at (ry + 1, rx + 1) in s_in
  for (int i = tid; i < kRingPx; i += kThreads) {
    const int ry = i / kRing;
    const int rx = i - ry * kRing;
    const int c = (ry + 1) * kIn + (rx + 1);
    const float vgx = abs_diff_sum3(s_in, c - kIn, c + kIn);
    const float vgy = abs_diff_sum3(s_in, c - 1, c + 1);
    const float ax = __fadd_rn(vgx, kEps);
    const float ay = __fadd_rn(vgy, kEps);
    const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)));
    const float dirx = fabsf(__fdiv_rn(ax, norm));
    const float diry = fabsf(__fdiv_rn(ay, norm));
    const float wx = __fdiv_rn(dirx, __fadd_rn(dirx, diry));
    const float wy = __fsub_rn(1.f, wx);

    float offs[kPh], sw[kPh], sr[kPh], sg[kPh], sb[kPh];
#pragma unroll
    for (int p = 0; p < kPh; ++p) {
      const float fx = (static_cast<float>(p % S) + 0.5f) / static_cast<float>(S);
      const float fy = (static_cast<float>(p / S) + 0.5f) / static_cast<float>(S);
      offs[p] = __fadd_rn(__fmul_rn(fx, wx), __fmul_rn(fy, wy));
      sw[p] = sr[p] = sg[p] = sb[p] = 0.f;
    }
#pragma unroll
    for (int ty = 0; ty < 4; ++ty) {
#pragma unroll
      for (int tx = 0; tx < 4; ++tx) {
        const int t = c + (ty - 1) * kIn + (tx - 1);
        const float tr = s_in[t];
        const float tg = s_in[kPlane + t];
        const float tb = s_in[2 * kPlane + t];
        const float base = __fadd_rn(__fmul_rn(static_cast<float>(tx), wx),
                                     __fmul_rn(static_cast<float>(ty), wy));
#pragma unroll
        for (int p = 0; p < kPh; ++p) {
          const float wt = fsr_cubic(fabsf(__fsub_rn(base, offs[p])));
          sw[p] = __fadd_rn(sw[p], wt);
          sr[p] = __fadd_rn(sr[p], __fmul_rn(tr, wt));
          sg[p] = __fadd_rn(sg[p], __fmul_rn(tg, wt));
          sb[p] = __fadd_rn(sb[p], __fmul_rn(tb, wt));
        }
      }
    }
    const float cr = s_in[c];
    const float cg = s_in[kPlane + c];
    const float cb = s_in[2 * kPlane + c];
#pragma unroll
    for (int p = 0; p < kPh; ++p) {
      const float den = fmaxf(sw[p], kEps);
      float r = __fdiv_rn(sr[p], den);
      float g = __fdiv_rn(sg[p], den);
      float b = __fdiv_rn(sb[p], den);
      if (mix) {
        r = __fadd_rn(r, __fmul_rn(__fsub_rn(cr, r), sharp));
        g = __fadd_rn(g, __fmul_rn(__fsub_rn(cg, g), sharp));
        b = __fadd_rn(b, __fmul_rn(__fsub_rn(cb, b), sharp));
      }
      const float lum =
          __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)), __fmul_rn(0.114f, b));
      s_e[p * kRingPx + i] = make_float4(r, g, b, lum);
    }
  }
  __syncthreads();

  // 3. RCAS per output pixel of the tile
  const int oh = S * h;
  const int ow = S * w;
  uchar4* out = dst + static_cast<size_t>(n) * oh * ow;
  for (int i = tid; i < kOut * kOut; i += kThreads) {
    const int ly = i / kOut;
    const int lx = i - ly * kOut;
    const int gy = S * y0 + ly;
    const int gx = S * x0 + lx;
    if (gy >= oh || gx >= ow) continue;
    const int r = ly / S + 1;  // ring coordinates of the input pixel
    const int c = lx / S + 1;
    const int py = ly % S;
    const int px = lx % S;
    const float4 cen = s_e[(py * S + px) * kRingPx + r * kRing + c];
    float4 top = py > 0 ? s_e[((py - 1) * S + px) * kRingPx + r * kRing + c]
                        : s_e[((S - 1) * S + px) * kRingPx + (r - 1) * kRing + c];
    float4 bot = py < S - 1 ? s_e[((py + 1) * S + px) * kRingPx + r * kRing + c]
                            : s_e[px * kRingPx + (r + 1) * kRing + c];
    float4 lef = px > 0 ? s_e[(py * S + px - 1) * kRingPx + r * kRing + c]
                        : s_e[(py * S + S - 1) * kRingPx + r * kRing + c - 1];
    float4 rig = px < S - 1 ? s_e[(py * S + px + 1) * kRingPx + r * kRing + c]
                            : s_e[(py * S) * kRingPx + r * kRing + c + 1];
    if (gy == 0) top = cen;
    if (gy == oh - 1) bot = cen;
    if (gx == 0) lef = cen;
    if (gx == ow - 1) rig = cen;
    const float min_l = fminf(fminf(fminf(top.w, bot.w), fminf(lef.w, rig.w)), cen.w);
    const float max_l = fmaxf(fmaxf(fmaxf(top.w, bot.w), fmaxf(lef.w, rig.w)), cen.w);
    const float t = clamp01(__fmul_rn(__fsub_rn(max_l, min_l), 5.f));
    const float smooth = __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.f, __fmul_rn(2.f, t)));
    const float strength = __fmul_rn(sharp, __fsub_rn(1.f, smooth));
#define NU_RCAS(ch)                                                                        \
  pack_trunc(__fadd_rn(                                                                    \
      cen.ch,                                                                              \
      __fmul_rn(__fsub_rn(__fsub_rn(__fsub_rn(__fsub_rn(__fmul_rn(4.f, cen.ch), top.ch), \
                                              bot.ch),                                     \
                                    lef.ch),                                               \
                          rig.ch),                                                         \
                strength)))
    out[static_cast<size_t>(gy) * ow + gx] = make_uchar4(NU_RCAS(x), NU_RCAS(y), NU_RCAS(z), 255);
#undef NU_RCAS
  }
}

template <int S>
int launch(const void* src, int n, int h, int w, float sharp, int mix, void* dst,
           cudaStream_t stream) {
  const int smem = S * S * kRing * kRing * static_cast<int>(sizeof(float4)) +
                   3 * kIn * kIn * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(fsr_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  fsr_kernel<S><<<grid, kThreads, smem, stream>>>(static_cast<const uchar4*>(src), h, w, sharp,
                                                  mix, static_cast<uchar4*>(dst));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (see nu_cuda_error_string).
int nu_fsr(int device, const void* src, int n, int h, int w, int scale, float sharp, int mix,
           void* dst, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || scale < 1 || scale > kMaxScale) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scale) {
    case 1: return launch<1>(src, n, h, w, sharp, mix, dst, s);
    case 2: return launch<2>(src, n, h, w, sharp, mix, dst, s);
    case 3: return launch<3>(src, n, h, w, sharp, mix, dst, s);
    default: return launch<4>(src, n, h, w, sharp, mix, dst, s);
  }
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
