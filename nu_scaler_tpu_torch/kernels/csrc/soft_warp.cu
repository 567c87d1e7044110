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
// float behaviour. The pack rounds half to even, like jnp.round and
// torch.round.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s fp32 counting an FMA as
// two operations, so 33.5 T instructions/s). At 1080p the bytes that must
// move are a, b and out, 3 x 8.29 MB = 24.9 MB, about 7.4 us. The operations
// depend on the data: per pixel 126 fp32 operations of cell and motion
// mixing, accumulation and packing, plus 42 per distinct corner candidate of
// each frame (two fractions, three lerps on four channels): 210 (one
// candidate in every cell) to 462 (four) per pixel, 0.44 to 0.96 G at 1080p.
// None of them may fuse, so each is one instruction: the floor is 13 to 29
// us, above the bytes; issued instructions bound the kernel.
//
// Design. A block of 32 x 8 threads owns one row of cells (blockIdx.y = cy:
// Ty + 1 of them, the first and last half-height, so no division finds a
// pixel's cell row; a launch for a band of rows runs the cell rows it
// touches and writes only its rows) and 128 columns; a thread owns G = 4 adjacent pixels of
// a row (th > 8: rows ty, ty + 8, ...).
//  * Once per thread, before the block's one barrier: its group's cell
//    column (the float reciprocal 1/tw and one exact correction step: no
//    integer division), and for both frames the four corners' motion and
//    candidate, loaded while the block loads the candidates.
//  * Per candidate of a corner (a corner whose candidate is the previous
//    corner's reuses its samples): the group's G + 1 columns of the two tap
//    rows are loaded once as words and each byte converted once without I2F
//    (its bits under 2^23's exponent, minus 2^23); each pixel's own lerp
//    chain reads them. Every pixel keeps its own fp32 chain in the plain
//    version's order; its sums start at +0, which leaves a first term >= +0
//    exact.
//  * The pack rounds without F2I: __fadd_rn(clip(v, 0, 255), 2^23) holds
//    rint(v) in its low byte. Each row of a group is one 16-byte store.
//  * A group whose pixels lie in two cells (a tile whose half-width G does
//    not divide: (8, 12) puts a cell boundary at column 6) or that crosses
//    the frame's right edge runs the same code one pixel at a time.
// 128 registers a thread (2 blocks an SM): fewer spill and run slower.
// Latency, not issue, holds it near 28% of its instruction floor: each
// block waits on its corners, candidates and taps in turn (PERF.md §6).
//
// C interface: nu_soft_warp_blend launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() of the launch; it computes a band of
// output rows (the whole frame, or one shard's rows of the sp mesh path).

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kGroup = 4;          // adjacent pixels a thread
constexpr int kBlockX = 32;        // groups across: 128 columns
constexpr int kBlockY = 8;         // rows of a cell, ty + 8i
constexpr int kMinBlocks = 2;      // blocks an SM holds: 128 registers a thread
constexpr int kMaxK = 8;
constexpr float kTwo23 = 8388608.0f;

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

// Byte k of p as a float, exactly: the byte under 2^23's exponent, minus 2^23.
__device__ __forceinline__ float byte_to_float(unsigned p, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(p, 0x4B000000u, 0x7540 + k)), kTwo23);
}

// A small non-negative integer as a float, exactly, without I2F.
__device__ __forceinline__ float small_to_float(int v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | static_cast<unsigned>(v)), kTwo23);
}

// rint(clip(v, 0, 255)) in the low byte: 2^23 + x rounded to nearest even.
__device__ __forceinline__ unsigned pack_round(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.f), 255.f), kTwo23));
}

// n / d for 0 <= n < 2^23: the reciprocal's quotient is off by at most one.
__device__ __forceinline__ int div_small(int n, int d, float inv_d) {
  int q = __float2int_rz(__fmul_rn(small_to_float(n), inv_d));
  q += (q + 1) * d <= n;
  q -= q * d > n;
  return q;
}

// The samples of G pixels at row r, columns c0 .. c0 + G - 1, at candidate
// offset (dy, dx) with fractions clip(sm - cand, 0, 1).
template <int G>
__device__ __forceinline__ void sample(const unsigned* __restrict__ img, int h, int w, int r,
                                       int c0, int idy, int idx, float dy, float dx,
                                       const float (&sm_y)[G], const float (&sm_x)[G],
                                       float4 (&s)[G]) {
  const unsigned* row0 = img + min(max(r + idy, 0), h - 1) * w;
  const unsigned* row1 = img + min(max(r + idy + 1, 0), h - 1) * w;
  unsigned t[G + 1], u[G + 1];
#pragma unroll
  for (int q = 0; q <= G; ++q) {
    const int col = min(max(c0 + idx + q, 0), w - 1);
    t[q] = __ldg(row0 + col);
    u[q] = __ldg(row1 + col);
  }
  float fyk[G], fxk[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    fyk[j] = clamp01(__fsub_rn(sm_y[j], dy));
    fxk[j] = clamp01(__fsub_rn(sm_x[j], dx));
  }
#define NU_CHANNEL(ch, k)                                                              \
  {                                                                                    \
    float tf[G + 1], uf[G + 1];                                                        \
    _Pragma("unroll") for (int q = 0; q <= G; ++q) {                                   \
      tf[q] = byte_to_float(t[q], k);                                                  \
      uf[q] = byte_to_float(u[q], k);                                                  \
    }                                                                                  \
    _Pragma("unroll") for (int j = 0; j < G; ++j) {                                    \
      const float top = lerp_rn(tf[j], tf[j + 1], fxk[j]);                             \
      const float bot = lerp_rn(uf[j], uf[j + 1], fxk[j]);                             \
      s[j].ch = lerp_rn(top, bot, fyk[j]);                                             \
    }                                                                                  \
  }
  NU_CHANNEL(x, 0)
  NU_CHANNEL(y, 1)
  NU_CHANNEL(z, 2)
  NU_CHANNEL(w, 3)
#undef NU_CHANNEL
}

// The four corner tiles of cell (cy, cx), rows cy-1 | cy and columns
// cx-1 | cx clamped to the tile grid, in both frames: motion (x, y) and
// candidate.
struct Corners {
  float2 m[2][4];
  int kk[2][4];
};

__device__ __forceinline__ Corners load_corners(const float2* __restrict__ tiles,
                                                const int* __restrict__ assign, int ty, int tx,
                                                int cy, int cx) {
  const int y0 = min(max(cy - 1, 0), ty - 1) * tx;
  const int y1 = min(max(cy, 0), ty - 1) * tx;
  const int x0 = min(max(cx - 1, 0), tx - 1);
  const int x1 = min(max(cx, 0), tx - 1);
  const int corner[4] = {y0 + x0, y0 + x1, y1 + x0, y1 + x1};
  Corners c;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c.m[f][i] = __ldg(tiles + f * ty * tx + corner[i]);
      c.kk[f][i] = __ldg(assign + f * ty * tx + corner[i]);
    }
  }
  return c;
}

// The G pixels at columns c0 .. c0 + G - 1 of cell (cy, cx), local column
// lc0 of the first, in the rows of the cell that this thread owns.
template <int G>
__device__ __forceinline__ void run_group(const uchar4* __restrict__ a,
                                          const uchar4* __restrict__ b, int h, int w,
                                          const Corners& cn, const int* s_cand,
                                          const float* s_candf, int k, int th, int cy, int lc0,
                                          int c0, float inv_th, float inv_tw, float w_a,
                                          float w_b, int row0, int row_end, uchar4* out) {
  float fx[G], gx[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    fx[j] = __fmul_rn(__fadd_rn(small_to_float(lc0 + j), 0.5f), inv_tw);
    gx[j] = __fsub_rn(1.f, fx[j]);
  }
  for (int lr = threadIdx.y; lr < th; lr += kBlockY) {
    const int r = cy * th - th / 2 + lr;
    if (r < row0 || r >= row_end) continue;
    const float fy = __fmul_rn(__fadd_rn(small_to_float(lr), 0.5f), inv_th);
    const float gy = __fsub_rn(1.f, fy);
    // sums start at +0: adding a first term x >= +0 to +0 gives x exactly
    float4 acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const unsigned* img = reinterpret_cast<const unsigned*>(f ? b : a);
      const float weight = f ? w_b : w_a;
      const int* cand = s_cand + f * 2 * k;  // y, then x
      const float* candf = s_candf + f * 2 * k;
      const float2* m = cn.m[f];
      const int* kk = cn.kk[f];
      float sm_y[G], sm_x[G];
      float4 v[G], s[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        sm_y[j] = __fadd_rn(
            __fmul_rn(gy, __fadd_rn(__fmul_rn(gx[j], m[0].y), __fmul_rn(fx[j], m[1].y))),
            __fmul_rn(fy, __fadd_rn(__fmul_rn(gx[j], m[2].y), __fmul_rn(fx[j], m[3].y))));
        sm_x[j] = __fadd_rn(
            __fmul_rn(gy, __fadd_rn(__fmul_rn(gx[j], m[0].x), __fmul_rn(fx[j], m[1].x))),
            __fmul_rn(fy, __fadd_rn(__fmul_rn(gx[j], m[2].x), __fmul_rn(fx[j], m[3].x))));
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a corner whose candidate is the previous corner's has its samples
        if (i == 0 || kk[i] != kk[i - 1]) {
          sample<G>(img, h, w, r, c0, cand[kk[i]], cand[k + kk[i]], candf[kk[i]],
                    candf[k + kk[i]], sm_y, sm_x, s);
        }
        const float wy_i = i < 2 ? gy : fy;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float bw = __fmul_rn(wy_i, (i & 1) ? fx[j] : gx[j]);
          v[j] = make_float4(__fadd_rn(v[j].x, __fmul_rn(bw, s[j].x)),
                             __fadd_rn(v[j].y, __fmul_rn(bw, s[j].y)),
                             __fadd_rn(v[j].z, __fmul_rn(bw, s[j].z)),
                             __fadd_rn(v[j].w, __fmul_rn(bw, s[j].w)));
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        acc[j] = make_float4(__fadd_rn(acc[j].x, __fmul_rn(weight, v[j].x)),
                             __fadd_rn(acc[j].y, __fmul_rn(weight, v[j].y)),
                             __fadd_rn(acc[j].z, __fmul_rn(weight, v[j].z)),
                             __fadd_rn(acc[j].w, __fmul_rn(weight, v[j].w)));
      }
    }
    unsigned px[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const unsigned rg = __byte_perm(pack_round(acc[j].x), pack_round(acc[j].y), 0x0040);
      const unsigned ba = __byte_perm(pack_round(acc[j].z), pack_round(acc[j].w), 0x0040);
      px[j] = __byte_perm(rg, ba, 0x5410);
    }
    unsigned* o = reinterpret_cast<unsigned*>(out) + static_cast<size_t>(r - row0) * w + c0;
    if constexpr (G == 4) {
      if ((w & 3) == 0) {
        *reinterpret_cast<uint4*>(o) = make_uint4(px[0], px[1], px[2], px[3]);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) o[j] = px[j];
  }
}

__global__ void __launch_bounds__(kBlockX * kBlockY, kMinBlocks) soft_warp_kernel(
    const uchar4* __restrict__ a, const uchar4* __restrict__ b, int h, int w,
    const float2* __restrict__ tiles, const int* __restrict__ assign,
    const int* __restrict__ cand, int k, int th, int tw, int ty, int tx, float inv_th,
    float inv_tw, float w_a, float w_b, int cy0, int row0, int row_end,
    uchar4* __restrict__ out) {
  const int c0 = (blockIdx.x * kBlockX + threadIdx.x) * kGroup;
  const int cy = cy0 + blockIdx.y;
  const int cx = div_small(c0 + tw / 2, tw, inv_tw);
  const int lc0 = c0 + tw / 2 - cx * tw;
  const bool whole = lc0 + kGroup <= tw && c0 + kGroup <= w;
  // the corners' loads are in flight with the candidates'
  Corners cn;
  if (whole) cn = load_corners(tiles, assign, ty, tx, cy, cx);

  // cand layout [frame][y | x][k], as ints and as floats
  __shared__ int s_cand[2 * 2 * kMaxK];
  __shared__ float s_candf[2 * 2 * kMaxK];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  if (tid < 4 * k) {
    s_cand[tid] = cand[tid];
    s_candf[tid] = static_cast<float>(cand[tid]);
  }
  __syncthreads();

  if (whole) {
    run_group<kGroup>(a, b, h, w, cn, s_cand, s_candf, k, th, cy, lc0, c0, inv_th, inv_tw, w_a,
                      w_b, row0, row_end, out);
    return;
  }
  // the group lies in two cells or crosses the frame's edge: pixel by pixel
  for (int j = 0; j < kGroup && c0 + j < w; ++j) {
    const int cxj = div_small(c0 + j + tw / 2, tw, inv_tw);
    run_group<1>(a, b, h, w, load_corners(tiles, assign, ty, tx, cy, cxj), s_cand, s_candf, k,
                 th, cy, c0 + j + tw / 2 - cxj * tw, c0 + j, inv_th, inv_tw, w_a, w_b, row0,
                 row_end, out);
  }
}

}  // namespace

extern "C" {

// Output rows row0 .. row0 + rows - 1 of the frame (all of it: 0, h) into
// out [rows, w]; every pixel is computed as in the whole frame's launch.
// Returns 0 on success, else a cudaError_t code (see nu_cuda_error_string).
int nu_soft_warp_blend(int device, const void* a, const void* b, int h, int w,
                       const void* tiles, const void* assign, const void* cand, int k,
                       int th, int tw, float inv_th, float inv_tw, float w_a, float w_b,
                       int row0, int rows, void* out, void* stream) {
  // soft_warp_cuda.MAX_WIDTH and MAX_CELL_ROWS: div_small needs c + tw/2 <
  // 2^23, and the grid has one block row per cell row
  if (k < 1 || k > kMaxK || th < 1 || tw < 1 || h % th != 0 || w % tw != 0 ||
      w >= (1 << 22) || h / th + 1 > 65535 || row0 < 0 || rows < 1 || row0 + rows > h) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  // one block row per cell row that the rows touch (of Ty + 1, the first
  // and last half-height) and 128 columns
  const int ty = h / th;
  const int cy0 = (row0 + th / 2) / th;
  const int cy1 = (row0 + rows - 1 + th / 2) / th;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX * kGroup - 1) / (kBlockX * kGroup), cy1 - cy0 + 1);
  soft_warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uchar4*>(a), static_cast<const uchar4*>(b), h, w,
      static_cast<const float2*>(tiles), static_cast<const int*>(assign),
      static_cast<const int*>(cand), k, th, tw, ty, w / tw, inv_th, inv_tw, w_a, w_b, cy0,
      row0, row0 + rows, static_cast<uchar4*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
