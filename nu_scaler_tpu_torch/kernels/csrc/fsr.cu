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
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s fp32 counting an FMA as
// two operations, so 33.5 T instructions/s: 128 lanes a clock on 132 SMs).
// At 1080p -> 4K (S = 2) the bytes are 8.29 MB in and 33.18 MB out, 12.4 us.
// The fp32 operations per input pixel are 79 + 373*S*S for EASU (direction
// 31; per tap 3; per tap and phase 22: distance 2, cubic 13, accumulation 7;
// per phase 3 for offs and 18 to normalise, mix and take luma; 9 fewer per
// phase without the mix) and 51 per output pixel for RCAS: 3.68 GFLOP at
// 1080p -> 4K. None of them may fuse, so each is one instruction: the floor
// is 0.088 ms, 7x the bytes. Issued instructions bound the kernel: every
// instruction that is not one of these operations (the cubic's compares and
// selects, loads, addresses, the division's and square root's fix-ups: 15
// correctly rounded divisions per input pixel at S = 2) adds to the time.
//
// Design. A block of 256 threads owns a tile of 32 input columns by R rows
// (R = 16 for S <= 2, two pixels a thread, rows ty and ty + 8; R = 8 for
// S >= 3, one): a warp is one tile row.
//  1. The input region (rows -2 .. R + 2, columns -2 .. 34) goes to shared
//     memory as planar fp32, all of a thread's loads issued before the first
//     wait, each byte converted without I2F: its bits under 2^23's exponent,
//     minus 2^23.
//  2. Each thread runs EASU for all S*S phases of its pixels, each phase's
//     16 taps in the plain version's order, into shared memory. Per tap and
//     phase only the FsrCubic branches that the tap can reach at that phase
//     are evaluated (cubic_branches: the distance lies between |tx - fx| and
//     |ty - fy| whatever the direction), and a tap whose weight is always 0
//     there is skipped: at S = 2, 23% fewer instructions in the tap loop.
//  3. The tile's one-pixel ring needs only the phases that face the tile:
//     the bottom phase row of the row above, the top phase row of the row
//     below, the right phase column of the column to the left and the left
//     column of the column to the right (no corners). Its 2*(32 + R) pixels
//     run S phases each on the first 2*(32 + R) threads, whole warps at R =
//     16 (a warp issues the same instructions for 10 active lanes as for
//     32, so spreading them over all warps would cost more issue slots).
//     The ring is 2*(32 + R)/(32*R*S) of the tile's EASU work: 9.4% at S = 2.
//  4. After one barrier each thread runs RCAS for the S x S outputs of its
//     pixels from shared memory: its own S*S phases and the 4*S facing
//     phases of its neighbours, one float4 load each, with no division or
//     modulo. (Keeping the own phases in registers across the barrier cost
//     4 blocks an SM at S = 2: 3% slower.) The pack is the trunc without
//     F2I: __fadd_rz(v, 2^23) of v = clip(out, 0, 1)*255 holds trunc(v) in
//     its low byte. Each output row of a pixel is one store of S*4 bytes (8
//     at S = 2, 16 at S = 4).
// Shared memory: S*S*(R + 2)*34*16 + 3*(R + 5)*37*4 bytes: 19 KB at S = 1,
// 47 KB at S = 2, 53 KB at S = 3, 91 KB at S = 4 (above 48 KB only with the
// dynamic shared-memory attribute, set per launch); blocks an SM holds: 4 at
// S <= 2, 3 at S = 3, 2 at S = 4 (the registers' launch bounds).
//
// C interface: nu_fsr launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include <utility>

#include "device_guard.cuh"

namespace {

constexpr int kTileW = 32;  // input columns per block: a warp per tile row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxScale = 4;

constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kThird = 1.0f / 3.0f;
constexpr float kEps = 1e-4f;
constexpr float kTwo23 = 8388608.0f;

// The tile of scale S: its rows, pixels a thread, and shared-memory shapes.
template <int S>
struct Tile {
  static constexpr int kRows = S <= 2 ? 16 : 8;
  static constexpr int kPix = kRows / kWarps;          // pixels a thread, kWarps rows apart
  static constexpr int kRingW = kTileW + 2;            // the tile and its one-pixel ring
  static constexpr int kRingH = kRows + 2;
  static constexpr int kRingPx = kRingW * kRingH;
  static constexpr int kInW = kTileW + 5;              // input columns -2 .. kTileW + 2
  static constexpr int kInH = kRows + 5;
  static constexpr int kPlane = kInW * kInH;
  static constexpr int kRingItems = 2 * (kTileW + kRows);
  static constexpr int kMinBlocks = S <= 2 ? 4 : (S == 3 ? 3 : 2);
  static constexpr int kSmem = S * S * kRingPx * 16 + 3 * kPlane * 4;
};

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// Byte k of p as a float in [0, 255], exactly: the byte under 2^23's
// exponent is 2^23 + byte.
__device__ __forceinline__ float byte_to_float(unsigned p, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(p, 0x4B000000u, 0x7540 + k)), kTwo23);
}

// trunc(clip(v, 0, 1) * 255) in the low byte: 2^23 + x rounded toward zero.
__device__ __forceinline__ unsigned pack_trunc(float v) {
  return __float_as_uint(__fadd_rz(__fmul_rn(clamp01(v), 255.f), kTwo23));
}

// The FsrCubic branches that tap (tx, ty) can take at phase (px, py) of
// scale S, whatever the direction: d = |(tx - fx)*wx + (ty - fy)*wy| with
// fx = (px + 0.5)/S, fy = (py + 0.5)/S, wx, wy >= 0 and wx + wy = 1 lies
// between |tx - fx| and |ty - fy| when they share a sign, else between 0 and
// the larger. The ends are at least 1/8 from 1 and 2; 1e-3 covers rounding.
constexpr int kNear = 1, kFar = 2, kZero = 4, kAny = kNear | kFar | kZero;

__host__ __device__ constexpr int cubic_branches(int tx, int ty, int px, int py, int s) {
  const double a = tx - (px + 0.5) / s;
  const double b = ty - (py + 0.5) / s;
  const double aa = a < 0 ? -a : a;
  const double bb = b < 0 ? -b : b;
  const double hi = (aa > bb ? aa : bb) + 1e-3;
  const double lo = (a * b >= 0 ? (aa < bb ? aa : bb) : 0.0) - 1e-3;
  return (lo <= 1 ? kNear : 0) | (hi > 1 && lo <= 2 ? kFar : 0) | (hi > 2 ? kZero : 0);
}

// FsrCubic on d >= 0: 2 - 1.5d - 0.5d^3 + d^2 to 1, -0.5d + 2.5d^2 - d^3 to
// 2, else 0; only the branches in B are evaluated.
template <int B>
__device__ __forceinline__ float fsr_cubic(float d) {
  const float d2 = __fmul_rn(d, d);
  const float d3 = __fmul_rn(d2, d);
  const float near = (B & kNear) ? __fadd_rn(__fsub_rn(__fsub_rn(2.f, __fmul_rn(1.5f, d)),
                                                       __fmul_rn(0.5f, d3)), d2)
                                 : 0.f;
  const float far = (B & kFar) ? __fsub_rn(__fadd_rn(__fmul_rn(-0.5f, d), __fmul_rn(2.5f, d2)), d3)
                               : 0.f;
  if constexpr (B == kNear) return near;
  if constexpr (B == kFar) return far;
  if constexpr (B == (kNear | kFar)) return d <= 1.f ? near : far;
  if constexpr (B == (kFar | kZero)) return d <= 2.f ? far : 0.f;
  return d <= 1.f ? near : (d <= 2.f ? far : 0.f);
}

template <int kPlane>
__device__ __forceinline__ float abs_diff_sum3(const float* p, int a, int b) {
  const float s0 = fabsf(__fsub_rn(p[a], p[b]));
  const float s1 = fabsf(__fsub_rn(p[kPlane + a], p[kPlane + b]));
  const float s2 = fabsf(__fsub_rn(p[2 * kPlane + a], p[2 * kPlane + b]));
  return __fmul_rn(__fadd_rn(__fadd_rn(s0, s1), s2), kThird);
}

// (k + 0.5) / S, the phase offset of row or column k.
template <int S>
__device__ __forceinline__ float phase_frac(int k) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f), static_cast<float>(S));
}

// One tap's share of every phase's sums. A phase where the tap's weight
// is always 0 is skipped: adding +0 leaves a sum unchanged (no sum is -0).
template <int B>
__device__ __forceinline__ void accumulate(float base, float offs, float tr, float tg, float tb,
                                           float& sw, float& sr, float& sg, float& sb) {
  if constexpr (B != kZero) {
    const float wt = fsr_cubic<B>(fabsf(__fsub_rn(base, offs)));
    sw = __fadd_rn(sw, wt);
    sr = __fadd_rn(sr, __fmul_rn(tr, wt));
    sg = __fadd_rn(sg, __fmul_rn(tg, wt));
    sb = __fadd_rn(sb, __fmul_rn(tb, wt));
  }
}

// The branches of tap (tx, ty) at phase p: known when the phases are all
// S*S in order (p = py*S + px), else any.
template <int S, bool kAllPhases>
__host__ __device__ constexpr int branches(int tx, int ty, int p) {
  return kAllPhases ? cubic_branches(tx, ty, p % S, p / S, S) : kAny;
}

template <class T, int S, bool kAllPhases, int NP, int TX, int TY, int... P>
__device__ __forceinline__ void easu_tap(const float* s_in, int c, float wx, float wy,
                                         const float (&offs)[NP], float (&sw)[NP],
                                         float (&sr)[NP], float (&sg)[NP], float (&sb)[NP],
                                         std::integer_sequence<int, P...>) {
  if constexpr (((branches<S, kAllPhases>(TX, TY, P) != kZero) || ...)) {
    const int t = c + (TY - 1) * T::kInW + (TX - 1);
    const float tr = s_in[t];
    const float tg = s_in[T::kPlane + t];
    const float tb = s_in[2 * T::kPlane + t];
    const float base = __fadd_rn(__fmul_rn(static_cast<float>(TX), wx),
                                 __fmul_rn(static_cast<float>(TY), wy));
    (accumulate<branches<S, kAllPhases>(TX, TY, P)>(base, offs[P], tr, tg, tb, sw[P], sr[P],
                                                    sg[P], sb[P]),
     ...);
  }
}

// The 16 taps in order, rows outer (tap i = ty*4 + tx).
template <class T, int S, bool kAllPhases, int NP, int... I>
__device__ __forceinline__ void easu_taps(const float* s_in, int c, float wx, float wy,
                                          const float (&offs)[NP], float (&sw)[NP],
                                          float (&sr)[NP], float (&sg)[NP], float (&sb)[NP],
                                          std::integer_sequence<int, I...>) {
  (easu_tap<T, S, kAllPhases, NP, I % 4, I / 4>(s_in, c, wx, wy, offs, sw, sr, sg, sb,
                                                 std::make_integer_sequence<int, NP>{}),
   ...);
}

// EASU of the input pixel centred at s_in[c] in NP phases with offsets
// (fx[p], fy[p]): (r, g, b, luma) of each phase in e[p]. kAllPhases: the
// phases are all S*S of the pixel in order, so each tap evaluates only the
// cubic branches it can take there.
template <class T, int S, bool kAllPhases, int NP>
__device__ __forceinline__ void easu(const float* s_in, int c, const float (&fx)[NP],
                                     const float (&fy)[NP], float sharp, int mix,
                                     float4 (&e)[NP]) {
  constexpr int kInW = T::kInW;
  constexpr int kPlane = T::kPlane;
  const float vgx = abs_diff_sum3<kPlane>(s_in, c - kInW, c + kInW);
  const float vgy = abs_diff_sum3<kPlane>(s_in, c - 1, c + 1);
  const float ax = __fadd_rn(vgx, kEps);
  const float ay = __fadd_rn(vgy, kEps);
  const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)));
  const float dirx = fabsf(__fdiv_rn(ax, norm));
  const float diry = fabsf(__fdiv_rn(ay, norm));
  const float wx = __fdiv_rn(dirx, __fadd_rn(dirx, diry));
  const float wy = __fsub_rn(1.f, wx);

  float offs[NP], sw[NP], sr[NP], sg[NP], sb[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    offs[p] = __fadd_rn(__fmul_rn(fx[p], wx), __fmul_rn(fy[p], wy));
    sw[p] = sr[p] = sg[p] = sb[p] = 0.f;
  }
  easu_taps<T, S, kAllPhases, NP>(s_in, c, wx, wy, offs, sw, sr, sg, sb,
                                  std::make_integer_sequence<int, 16>{});
  const float cr = s_in[c];
  const float cg = s_in[kPlane + c];
  const float cb = s_in[2 * kPlane + c];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
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
    e[p] = make_float4(r, g, b, lum);
  }
}

// RCAS of one output pixel, packed RGBA with alpha 255.
__device__ __forceinline__ unsigned rcas(float4 cen, float4 top, float4 bot, float4 lef,
                                         float4 rig, float sharp) {
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
  const unsigned rg = __byte_perm(NU_RCAS(x), NU_RCAS(y), 0x0040);
  const unsigned ba = __byte_perm(NU_RCAS(z), 0xFFu, 0x0040);
#undef NU_RCAS
  return __byte_perm(rg, ba, 0x5410);
}

// One output row of a pixel: S packed pixels, one store.
template <int S>
__device__ __forceinline__ void store_row(unsigned* o, const unsigned (&v)[S]) {
  if constexpr (S == 2) {
    *reinterpret_cast<uint2*>(o) = make_uint2(v[0], v[1]);
  } else if constexpr (S == 4) {
    *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) o[i] = v[i];
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, Tile<S>::kMinBlocks)
    fsr_kernel(const uchar4* __restrict__ src, int h, int w, float sharp, int mix,
               uchar4* __restrict__ dst) {
  using T = Tile<S>;
  constexpr int kPh = S * S;
  extern __shared__ float4 smem[];
  float4* s_e = smem;                                                // [kPh][kRingH][kRingW]
  float* s_in = reinterpret_cast<float*>(smem + kPh * T::kRingPx);  // [3][kInH][kInW]

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * T::kRows;
  const int x0 = blockIdx.x * kTileW;
  const unsigned* img = reinterpret_cast<const unsigned*>(src) + static_cast<size_t>(n) * h * w;
  const int tid = threadIdx.x;
  const int tx = tid % 32;
  const int ty = tid / 32;

  // 1. the input region, edge-clamped, planar fp32 in [0, 1]
  //    (every load issued before the first conversion waits on one)
  constexpr int kRounds = (T::kPlane + kThreads - 1) / kThreads;
  unsigned words[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = min(tid + j * kThreads, T::kPlane - 1);
    const int iy = i / T::kInW;
    const int ix = i - iy * T::kInW;
    const int gy = min(max(y0 - 2 + iy, 0), h - 1);
    const int gx = min(max(x0 - 2 + ix, 0), w - 1);
    words[j] = __ldg(img + static_cast<size_t>(gy) * w + gx);
  }
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = tid + j * kThreads;
    if (i < T::kPlane) {
      s_in[i] = __fmul_rn(byte_to_float(words[j], 0), kInv255);
      s_in[T::kPlane + i] = __fmul_rn(byte_to_float(words[j], 1), kInv255);
      s_in[2 * T::kPlane + i] = __fmul_rn(byte_to_float(words[j], 2), kInv255);
    }
  }
  __syncthreads();

  // 2. EASU of the thread's pixels in all phases, into shared memory; ringed
  //    pixel (ry, rx) is input (y0 - 1 + ry, x0 - 1 + rx), at (ry + 1, rx + 1)
  //    in s_in and ry * kRingW + rx in each phase plane of s_e
  float fx[kPh], fy[kPh];
#pragma unroll
  for (int p = 0; p < kPh; ++p) {
    fx[p] = phase_frac<S>(p % S);
    fy[p] = phase_frac<S>(p / S);
  }
#pragma unroll
  for (int i = 0; i < T::kPix; ++i) {
    const int ry = ty + kWarps * i + 1;
    const int rx = tx + 1;
    float4 e[kPh];
    easu<T, S, true>(s_in, (ry + 1) * T::kInW + rx + 1, fx, fy, sharp, mix, e);
#pragma unroll
    for (int p = 0; p < kPh; ++p) s_e[p * T::kRingPx + ry * T::kRingW + rx] = e[p];
  }

  // 3. the ring: the S phases of each ring pixel that face the tile
  if (tid < T::kRingItems) {
    int ry, rx, fixed;
    bool row;  // a phase row (above and below the tile) or a phase column
    if (tid < kTileW) {
      row = true, ry = 0, rx = tid + 1, fixed = S - 1;
    } else if (tid < 2 * kTileW) {
      row = true, ry = T::kRows + 1, rx = tid - kTileW + 1, fixed = 0;
    } else if (tid < 2 * kTileW + T::kRows) {
      row = false, ry = tid - 2 * kTileW + 1, rx = 0, fixed = S - 1;
    } else {
      row = false, ry = tid - 2 * kTileW - T::kRows + 1, rx = kTileW + 1, fixed = 0;
    }
    const float f_fixed = phase_frac<S>(fixed);
    float rfx[S], rfy[S];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      rfx[q] = row ? phase_frac<S>(q) : f_fixed;
      rfy[q] = row ? f_fixed : phase_frac<S>(q);
    }
    float4 e[S];
    easu<T, S, false>(s_in, (ry + 1) * T::kInW + rx + 1, rfx, rfy, sharp, mix, e);
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int p = row ? fixed * S + q : q * S + fixed;
      s_e[p * T::kRingPx + ry * T::kRingW + rx] = e[q];
    }
  }
  __syncthreads();

  // 4. RCAS of the thread's S x S outputs per pixel
  const int oh = S * h;
  const int ow = S * w;
  unsigned* out = reinterpret_cast<unsigned*>(dst) + static_cast<size_t>(n) * oh * ow;
#pragma unroll
  for (int i = 0; i < T::kPix; ++i) {
    const int y = y0 + ty + kWarps * i;
    const int x = x0 + tx;
    if (y >= h || x >= w) continue;
    const float4* e = s_e + (ty + kWarps * i + 1) * T::kRingW + tx + 1;
    // the EASU value at output (S*y + qy, S*x + qx), qy and qx in -1 .. S:
    // a phase of this pixel or of a neighbour's
    const auto at = [e](int qy, int qx) {
      const int oy = qy < 0 ? -1 : (qy < S ? 0 : 1);
      const int ox = qx < 0 ? -1 : (qx < S ? 0 : 1);
      return e[((qy - oy * S) * S + qx - ox * S) * T::kRingPx + oy * T::kRingW + ox];
    };
#pragma unroll
    for (int py = 0; py < S; ++py) {
      unsigned v[S];
#pragma unroll
      for (int px = 0; px < S; ++px) {
        const float4 cen = at(py, px);
        // at the output image's edge, the centre itself
        const float4 top = py == 0 && y == 0 ? cen : at(py - 1, px);
        const float4 bot = py == S - 1 && y == h - 1 ? cen : at(py + 1, px);
        const float4 lef = px == 0 && x == 0 ? cen : at(py, px - 1);
        const float4 rig = px == S - 1 && x == w - 1 ? cen : at(py, px + 1);
        v[px] = rcas(cen, top, bot, lef, rig, sharp);
      }
      store_row<S>(out + static_cast<size_t>(S * y + py) * ow + S * x, v);
    }
  }
}

template <int S>
int launch(const void* src, int n, int h, int w, float sharp, int mix, void* dst,
           cudaStream_t stream) {
  using T = Tile<S>;
  cudaError_t e = cudaFuncSetAttribute(fsr_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + T::kRows - 1) / T::kRows, n);
  fsr_kernel<S><<<grid, kThreads, T::kSmem, stream>>>(static_cast<const uchar4*>(src), h, w,
                                                      sharp, mix, static_cast<uchar4*>(dst));
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
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
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
