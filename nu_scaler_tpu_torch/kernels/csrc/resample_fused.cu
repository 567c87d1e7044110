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
// Order of operations, per output (the bytes depend on it, and
// resample_twopass.cu follows it too): the vertical sum is the fmaf chain
// acc = fmaf(wv[k], x[first + k], acc) over k in order from acc = 0, on fp32
// values of the u8 inputs; the horizontal sum is the same chain over the
// vertical sums; then the trunc pack; the cross-fade is a + (b - a) * t with
// each operation rounded on its own (no FMA) and rounded half to even.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32; published
// peaks). At 1080p -> 4K lanczos3 one frame moves 41.5 MB (8.3 MB in, 33.2
// MB out): 12.4 us. Its 6-tap chains are 0.75 GFLOP of FMA (11 us at the
// fp32 rate, 22 us at one FMA instruction a lane a clock), so the kernel has
// to keep the tap loops to FMAs and the rest of its instructions few.
//
// Design (persistent blocks; 256 threads; tile_h x tile_w outputs a tile,
// 64 x 128 at the main shape):
//  * A block walks the tiles blockIdx.x, + gridDim.x, ...; the grid is as
//    many blocks as fit on the card at once. Each tile's input footprint
//    lands in shared memory as u8 RGBA by cp.async (16 bytes a copy where
//    the rows allow it), into one of two buffers: the next tile's footprint
//    is loaded while this tile computes. Where two buffers do not fit, the
//    next load starts as soon as the vertical pass is done with the only one.
//  * The tap tables come as dense bands, built once per plan on the host
//    (resample_cuda.band_tables) and copied with the footprint by cp.async
//    into one of two table buffers: for each run of 8 output rows, the
//    weight of every input row of the run's window for each of the 8 rows
//    (zero outside a row's band), and for each group of 4 output columns the
//    same over the group's window of intermediate columns, a float4 per
//    window column. A zero-weight fmaf adds +0 or -0, which leaves a finite
//    nonzero or +0 sum as it is (and the sum is never -0), so the dense
//    chains give every output exactly the chain of its own taps, in order.
//  * Vertical pass: a thread owns one intermediate column of a run of 8
//    rows: it reads each footprint value of the window once (4 bytes),
//    turns it into 4 floats without an I2F (the byte under 2^23's exponent,
//    minus 2^23: exact), and adds it into 8 float4 sums (32 FMAs). The
//    intermediate is stored column-major, [fc][tile_h + 1] float4 (the odd
//    stride keeps both passes' accesses free of bank conflicts).
//  * Horizontal pass: a thread owns 4 neighbouring outputs in each of two
//    rows (r and r + tile_h / 2); a warp's lanes are 8 rows by 4 groups, so
//    each quarter-warp reads 8 consecutive rows of one intermediate column
//    (128 contiguous bytes) and every weight float4 serves two rows: per
//    window column two float4 reads of the intermediate and one of weights
//    for 32 FMAs. The trunc pack is __fadd_rz(v, 2^23) of the clamped sum
//    (no F2I); the 4 pixels are packed with byte permutes and stored as 16
//    bytes (4 lanes write 64 contiguous bytes of a row); the cross-fade reads
//    prev as 16 bytes before the sums, rounds by __fadd_rn(m, 2^23) of the
//    clamped mix and stores 16 bytes per mid.
//
// C interface: nu_resample_fused launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a plan whose shared memory does not add up).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRB = 8;                // output rows of a vertical work item
constexpr int kGW = 4;                // output columns of a horizontal work item
constexpr float kMagic = 8388608.0f;  // 2^23: its float's low mantissa byte is an integer 0..255

struct Plan {
  int n, h, w, oh, ow, kv, kh;
  int tile_h, tile_w, fr, fc, fcw, wv, wh, nbuf;
  int nrb, nrbp, ngr, ngrp;  // runs and groups of a tile; their window starts padded to 4
  int tiles_x, tiles_y, ntiles;
  int foot_bytes, tab_bytes, tab_vs, tab_dh, tab_hs, off_tab, off_inter, ist;
  int vec_in, vec_out;  // 16-byte loads of the input, 16-byte loads / stores of the outputs
};

// the shared-memory layout; the same sum as resample_cuda.smem_bytes:
// footprints, two table buffers (dv | vs | dh | hs), the intermediate
Plan make_plan(int n, int h, int w, int oh, int ow, int kv, int kh, int tile_h, int tile_w,
               int fr, int fc, int wv, int wh, int nbuf) {
  Plan p{};
  p.n = n; p.h = h; p.w = w; p.oh = oh; p.ow = ow; p.kv = kv; p.kh = kh;
  p.tile_h = tile_h; p.tile_w = tile_w; p.fr = fr; p.fc = fc; p.wv = wv; p.wh = wh; p.nbuf = nbuf;
  p.fcw = (fc + 3 + 3) / 4 * 4;  // a footprint row from the 16-byte-aligned column at or below c0
  p.nrb = tile_h / kRB;
  p.nrbp = (p.nrb + 3) / 4 * 4;
  p.ngr = tile_w / kGW;
  p.ngrp = (p.ngr + 3) / 4 * 4;
  p.tiles_x = (ow + tile_w - 1) / tile_w;
  p.tiles_y = (oh + tile_h - 1) / tile_h;
  p.ntiles = p.tiles_x * p.tiles_y * n;
  p.foot_bytes = fr * p.fcw * 4;
  p.tab_vs = p.nrb * wv * kRB * 4;
  p.tab_dh = p.tab_vs + p.nrbp * 4;
  p.tab_hs = p.tab_dh + wh * p.ngr * 16;
  p.tab_bytes = p.tab_hs + p.ngrp * 4;
  p.off_tab = nbuf * p.foot_bytes;
  p.off_inter = p.off_tab + 2 * p.tab_bytes;
  p.ist = tile_h + 1;
  return p;
}

int smem_of(const Plan& p) { return p.off_inter + p.fc * p.ist * 16; }

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

__device__ __forceinline__ uint32_t pack_trunc(float4 v, float4& cur) {
  const uint32_t x = trunc_bits(v.x), y = trunc_bits(v.y), z = trunc_bits(v.z), w = trunc_bits(v.w);
  // the packed values as floats, for the cross-fade
  cur = make_float4(__fsub_rn(__uint_as_float(x), kMagic), __fsub_rn(__uint_as_float(y), kMagic),
                    __fsub_rn(__uint_as_float(z), kMagic), __fsub_rn(__uint_as_float(w), kMagic));
  return pack_low_bytes(x, y, z, w);
}

// clip(rint(a + (b - a) * t), 0, 255) for one channel, as the bits of 2^23 +
// the result: clamping before rounding gives the same integer (rint is
// monotone and the bounds are integers), and on [0, 255] adding 2^23 rounds
// half to even exactly as rintf
__device__ __forceinline__ uint32_t mix_bits(float a, float b, float t) {
  const float m = __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), t));
  return __float_as_uint(__fadd_rn(fminf(fmaxf(m, 0.f), 255.f), kMagic));
}

__device__ __forceinline__ uint32_t mix_px(uint32_t prev, float4 cur, float t) {
  const float4 a = unpack(prev);
  return pack_low_bytes(mix_bits(a.x, cur.x, t), mix_bits(a.y, cur.y, t), mix_bits(a.z, cur.z, t),
                        mix_bits(a.w, cur.w, t));
}

struct Tile {
  int z, ty, tx, oy0, ox0, th, tw, r0, fr, c0, c0a, fc;
};

__device__ __forceinline__ Tile tile_of(const Plan& p, int t, const int* __restrict__ first_v,
                                        const int* __restrict__ first_h) {
  Tile g;
  g.tx = t % p.tiles_x;
  const int rest = t / p.tiles_x;
  g.z = rest / p.tiles_y;
  g.ty = rest - g.z * p.tiles_y;
  g.oy0 = g.ty * p.tile_h;
  g.ox0 = g.tx * p.tile_w;
  g.th = min(p.tile_h, p.oh - g.oy0);
  g.tw = min(p.tile_w, p.ow - g.ox0);
  g.r0 = __ldg(first_v + g.oy0);
  g.fr = __ldg(first_v + g.oy0 + g.th - 1) + p.kv - g.r0;
  g.c0 = __ldg(first_h + g.ox0);
  g.fc = __ldg(first_h + g.ox0 + g.tw - 1) + p.kh - g.c0;
  g.c0a = p.vec_in ? (g.c0 & ~3) : g.c0;
  return g;
}

__device__ __forceinline__ void copy16(uint32_t dst, const void* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads) {
    cp_async16(dst + 16 * i, static_cast<const unsigned char*>(src) + 16 * i, 16u);
  }
}

// the tile's footprint rows r0 .. r0 + fr - 1, columns c0a .., into a buffer
// whose rows are fcw pixels (16-byte copies when the input rows allow
// them), and its tile row's and tile column's band tables
__device__ __forceinline__ void load_tile(const Plan& p, const Tile& g, const uchar4* __restrict__ src,
                                          uint32_t foot, uint32_t tab, const float* __restrict__ dvt,
                                          const int* __restrict__ vst, const float4* __restrict__ dht,
                                          const int* __restrict__ hst) {
  const uchar4* img = src + static_cast<size_t>(g.z) * p.h * p.w;
  if (p.vec_in) {
    const int chunks = (g.c0 - g.c0a + g.fc + 3) / 4;
    for (int i = threadIdx.x; i < g.fr * chunks; i += kThreads) {
      const int r = i / chunks, q = i - r * chunks;
      const int col = g.c0a + 4 * q;
      const bool in = col < p.w;  // w % 4 == 0: a chunk is all in or all out
      const uchar4* s = in ? img + static_cast<size_t>(g.r0 + r) * p.w + col : src;
      cp_async16(foot + (r * p.fcw + 4 * q) * 4, s, in ? 16u : 0u);
    }
  } else {
    for (int i = threadIdx.x; i < g.fr * g.fc; i += kThreads) {
      const int r = i / g.fc, c = i - r * g.fc;
      cp_async4(foot + (r * p.fcw + c) * 4, img + static_cast<size_t>(g.r0 + r) * p.w + g.c0 + c);
    }
  }
  copy16(tab, dvt + static_cast<size_t>(g.ty) * p.nrb * p.wv * kRB, p.tab_vs);
  copy16(tab + p.tab_vs, vst + static_cast<size_t>(g.ty) * p.nrbp, p.nrbp * 4);
  copy16(tab + p.tab_dh, dht + static_cast<size_t>(g.tx) * p.wh * p.ngr, p.wh * p.ngr * 16);
  copy16(tab + p.tab_hs, hst + static_cast<size_t>(g.tx) * p.ngrp, p.ngrp * 4);
}

// trunc-pack 4 outputs of one row and store them (and the cross-fades)
template <int NT>
__device__ __forceinline__ void finish_group(const Plan& p, const float4 (&acc)[kGW], size_t o, int live,
                                             uint4 pv, float t0, float t1, uchar4* __restrict__ dst,
                                             uchar4* __restrict__ mid0, uchar4* __restrict__ mid1) {
  float4 c[kGW];
  uint4 px;
  px.x = pack_trunc(acc[0], c[0]);
  px.y = pack_trunc(acc[1], c[1]);
  px.z = pack_trunc(acc[2], c[2]);
  px.w = pack_trunc(acc[3], c[3]);
  uint4 m0, m1;
  if constexpr (NT > 0) {
    m0 = make_uint4(mix_px(pv.x, c[0], t0), mix_px(pv.y, c[1], t0), mix_px(pv.z, c[2], t0),
                    mix_px(pv.w, c[3], t0));
  }
  if constexpr (NT > 1) {
    m1 = make_uint4(mix_px(pv.x, c[0], t1), mix_px(pv.y, c[1], t1), mix_px(pv.z, c[2], t1),
                    mix_px(pv.w, c[3], t1));
  }
  if (p.vec_out && live == kGW) {
    *reinterpret_cast<uint4*>(dst + o) = px;
    if constexpr (NT > 0) *reinterpret_cast<uint4*>(mid0 + o) = m0;
    if constexpr (NT > 1) *reinterpret_cast<uint4*>(mid1 + o) = m1;
  } else {
    const uint32_t pw[kGW] = {px.x, px.y, px.z, px.w};
    for (int e = 0; e < live; ++e) reinterpret_cast<uint32_t*>(dst)[o + e] = pw[e];
    if constexpr (NT > 0) {
      const uint32_t mw[kGW] = {m0.x, m0.y, m0.z, m0.w};
      for (int e = 0; e < live; ++e) reinterpret_cast<uint32_t*>(mid0)[o + e] = mw[e];
    }
    if constexpr (NT > 1) {
      const uint32_t mw[kGW] = {m1.x, m1.y, m1.z, m1.w};
      for (int e = 0; e < live; ++e) reinterpret_cast<uint32_t*>(mid1)[o + e] = mw[e];
    }
  }
}

template <int NT>
__device__ __forceinline__ uint4 load_prev(const Plan& p, const uchar4* __restrict__ prev, size_t o,
                                           int live) {
  if constexpr (NT == 0) {
    return make_uint4(0u, 0u, 0u, 0u);
  } else {
    if (p.vec_out && live == kGW) return __ldg(reinterpret_cast<const uint4*>(prev + o));
    uint32_t tmp[kGW] = {0u, 0u, 0u, 0u};
    for (int e = 0; e < live; ++e) tmp[e] = __ldg(reinterpret_cast<const uint32_t*>(prev + o + e));
    return make_uint4(tmp[0], tmp[1], tmp[2], tmp[3]);
  }
}

// the horizontal chains of one group of 4 outputs in row r (and, with TWO,
// in row r + half), over the group's window of intermediate columns
template <bool TWO>
__device__ __forceinline__ void horizontal_sums(const Plan& p, const float4* inter, const float4* dh,
                                                int start, int q, int fc, int r, int half,
                                                float4 (&a)[kGW], float4 (&b)[kGW]) {
#pragma unroll
  for (int e = 0; e < kGW; ++e) a[e] = b[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < p.wh; ++j) {
    const float4* icol = inter + min(start + j, fc - 1) * p.ist;  // past the band the weights are 0
    const float4 wq = dh[j * p.ngr + q];
    const float4 v = icol[r];
    a[0] = fma4(wq.x, v, a[0]);
    a[1] = fma4(wq.y, v, a[1]);
    a[2] = fma4(wq.z, v, a[2]);
    a[3] = fma4(wq.w, v, a[3]);
    if (TWO) {
      const float4 v2 = icol[r + half];
      b[0] = fma4(wq.x, v2, b[0]);
      b[1] = fma4(wq.y, v2, b[1]);
      b[2] = fma4(wq.z, v2, b[2]);
      b[3] = fma4(wq.w, v2, b[3]);
    }
  }
}

// NT: number of cross-fade outputs (0, 1 or 2).
template <int NT>
__global__ void __launch_bounds__(kThreads, 2) resample_fused_kernel(
    const uchar4* __restrict__ src, const int* __restrict__ first_v, const int* __restrict__ first_h,
    const float* __restrict__ dvt, const int* __restrict__ vst, const float4* __restrict__ dht,
    const int* __restrict__ hst, const Plan p, const uchar4* __restrict__ prev, float t0, float t1,
    uchar4* __restrict__ dst, uchar4* __restrict__ mid0, uchar4* __restrict__ mid1) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* inter = reinterpret_cast<float4*>(smem + p.off_inter);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the horizontal pass: a warp-item is 8 rows (two sets when tile_h / 8 is
  // even: rows r and r + tile_h / 2) by 4 groups
  const int octets = p.tile_h / kRB;
  const bool two = octets % 2 == 0;
  const int row_sets = two ? octets / 2 : octets;
  const int half = two ? p.tile_h / 2 : 0;
  const int qblocks = (p.ngr + 3) / 4;

  int t = blockIdx.x;
  if (t >= p.ntiles) return;
  Tile g = tile_of(p, t, first_v, first_h);
  load_tile(p, g, src, base, base + p.off_tab, dvt, vst, dht, hst);
  cp_async_commit();

  for (int it = 0; t < p.ntiles; ++it, t += gridDim.x) {
    const int fbuf = it % p.nbuf, tbuf = it & 1;
    const int tn = t + gridDim.x;
    Tile gn{};
    if (tn < p.ntiles) gn = tile_of(p, tn, first_v, first_h);
    if (p.nbuf == 2) {  // the other buffers were last read before the previous tile's last barrier
      if (tn < p.ntiles) {
        load_tile(p, gn, src, base + (fbuf ^ 1) * p.foot_bytes, base + p.off_tab + (tbuf ^ 1) * p.tab_bytes,
                  dvt, vst, dht, hst);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this tile's footprint and tables; the next ones may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* tab = smem + p.off_tab + tbuf * p.tab_bytes;
    const float* dv = reinterpret_cast<const float*>(tab);
    const int* vs = reinterpret_cast<const int*>(tab + p.tab_vs);
    const float4* dh = reinterpret_cast<const float4*>(tab + p.tab_dh);
    const int* hs = reinterpret_cast<const int*>(tab + p.tab_hs);

    // vertical pass: intermediate column c of rows 8b .. 8b + 7
    const uint32_t* foot = reinterpret_cast<const uint32_t*>(smem + fbuf * p.foot_bytes);
    const int coff = g.c0 - g.c0a;
    const int runs = (g.th + kRB - 1) / kRB;
    for (int i = tid; i < runs * g.fc; i += kThreads) {
      const int b = i / g.fc, c = i - b * g.fc;
      const int start = vs[b];
      const float4* wrow = reinterpret_cast<const float4*>(dv + b * p.wv * kRB);
      float4 acc[kRB];
#pragma unroll
      for (int rr = 0; rr < kRB; ++rr) acc[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < p.wv; ++j) {
        const int row = min(start + j, g.fr - 1);  // past the band the weights are 0
        const float4 v = unpack(foot[row * p.fcw + coff + c]);
        const float4 wa = wrow[2 * j], wb = wrow[2 * j + 1];
        acc[0] = fma4(wa.x, v, acc[0]);
        acc[1] = fma4(wa.y, v, acc[1]);
        acc[2] = fma4(wa.z, v, acc[2]);
        acc[3] = fma4(wa.w, v, acc[3]);
        acc[4] = fma4(wb.x, v, acc[4]);
        acc[5] = fma4(wb.y, v, acc[5]);
        acc[6] = fma4(wb.z, v, acc[6]);
        acc[7] = fma4(wb.w, v, acc[7]);
      }
      float4* col = inter + c * p.ist + b * kRB;
#pragma unroll
      for (int rr = 0; rr < kRB; ++rr) col[rr] = acc[rr];  // rows past th are never read
    }
    __syncthreads();
    if (p.nbuf == 1) {  // the only footprint buffer is free: the next tile loads under the horizontal pass
      if (tn < p.ntiles) {
        load_tile(p, gn, src, base, base + p.off_tab + (tbuf ^ 1) * p.tab_bytes, dvt, vst, dht, hst);
      }
      cp_async_commit();
    }

    // horizontal pass, trunc pack and the cross-fade: 4 outputs in each of
    // rows r and r + half
    const size_t plane = static_cast<size_t>(g.z) * p.oh * p.ow;
    const int groups = (g.tw + kGW - 1) / kGW;
    for (int wi = warp; wi < row_sets * qblocks; wi += kThreads / 32) {
      const int os = wi % row_sets, qb = wi / row_sets;
      const int r = os * kRB + (lane & 7);
      const int q = qb * 4 + (lane >> 3);
      if (q >= groups || r >= g.th) continue;
      const bool second = two && r + half < g.th;
      const int x0 = g.ox0 + q * kGW;
      const int live = min(kGW, g.ox0 + g.tw - x0);
      const size_t o = plane + static_cast<size_t>(g.oy0 + r) * p.ow + x0;
      const size_t o2 = o + static_cast<size_t>(half) * p.ow;
      const uint4 pv = load_prev<NT>(p, prev, o, live);
      const uint4 pv2 = second ? load_prev<NT>(p, prev, o2, live) : make_uint4(0u, 0u, 0u, 0u);
      float4 a[kGW], b2[kGW];
      if (two) {  // the same for the whole launch; rows past th compute unused sums
        horizontal_sums<true>(p, inter, dh, hs[q], q, g.fc, r, half, a, b2);
      } else {
        horizontal_sums<false>(p, inter, dh, hs[q], q, g.fc, r, half, a, b2);
      }
      finish_group<NT>(p, a, o, live, pv, t0, t1, dst, mid0, mid1);
      if (second) finish_group<NT>(p, b2, o2, live, pv2, t0, t1, dst, mid0, mid1);
    }
    __syncthreads();  // the intermediate and this tile's buffers are free
    g = gn;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <int NT>
int launch(const void* src, const void* first_v, const void* first_h, const void* dvt, const void* vst,
           const void* dht, const void* hst, Plan p, int smem_bytes, const void* prev, float t0, float t1,
           void* dst, void* mid0, void* mid1, cudaStream_t stream) {
  auto kernel = resample_fused_kernel<NT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = p.ntiles < per_sm * sms ? p.ntiles : per_sm * sms;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const uchar4*>(src), static_cast<const int*>(first_v), static_cast<const int*>(first_h),
      static_cast<const float*>(dvt), static_cast<const int*>(vst), static_cast<const float4*>(dht),
      static_cast<const int*>(hst), p, static_cast<const uchar4*>(prev), t0, t1, static_cast<uchar4*>(dst),
      static_cast<uchar4*>(mid0), static_cast<uchar4*>(mid1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tile plan (resample_cuda.tile_plan): tile_h (a multiple of 8) x tile_w
// (a multiple of 4) outputs, the largest footprint fr x fc of any tile, the
// widest window wv of 8 output rows and wh of 4 output columns, nbuf
// footprint buffers (1 or 2) and the shared memory they add up to; the band
// tables (resample_cuda.band_tables): dvt float [tiles_y][tile_h / 8][wv][8],
// vst int [tiles_y][tile_h / 8 padded to 4], dht float4
// [tiles_x][wh][tile_w / 4], hst int [tiles_x][tile_w / 4 padded to 4], all
// 16-byte aligned. Returns 0 on success, else a cudaError_t code (see
// nu_cuda_error_string).
int nu_resample_fused(int device, const void* src, int n, int h, int w,
                      const void* first_v, int kv, const void* first_h, int kh,
                      int oh, int ow, int tile_h, int tile_w, int fr, int fc, int wv, int wh,
                      int nbuf, int smem_bytes,
                      const void* dvt, const void* vst, const void* dht, const void* hst,
                      const void* prev, int n_ts, float t0, float t1,
                      void* dst, void* mid0, void* mid1, void* stream) {
  if (n < 1 || h < 1 || w < 1 || oh < 1 || ow < 1 || kv < 1 || kh < 1 || tile_h < kRB ||
      tile_h % kRB || tile_w < kGW || tile_w % kGW || fr < 1 || fc < 1 || wv < 1 || wh < 1 ||
      (nbuf != 1 && nbuf != 2) || n_ts < 0 || n_ts > 2 || (n_ts > 0 && prev == nullptr) ||
      !aligned16(dvt) || !aligned16(vst) || !aligned16(dht) || !aligned16(hst)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p = make_plan(n, h, w, oh, ow, kv, kh, tile_h, tile_w, fr, fc, wv, wh, nbuf);
  if (smem_of(p) != smem_bytes || static_cast<long long>(p.tiles_x) * p.tiles_y * n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.vec_in = (w % 4 == 0) && aligned16(src);
  p.vec_out = (ow % 4 == 0) && aligned16(dst) && (n_ts < 1 || (aligned16(prev) && aligned16(mid0))) &&
              (n_ts < 2 || aligned16(mid1));
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_ts) {
    case 0:
      return launch<0>(src, first_v, first_h, dvt, vst, dht, hst, p, smem_bytes, prev, t0, t1, dst, mid0,
                       mid1, s);
    case 1:
      return launch<1>(src, first_v, first_h, dvt, vst, dht, hst, p, smem_bytes, prev, t0, t1, dst, mid0,
                       mid1, s);
    default:
      return launch<2>(src, first_v, first_h, dvt, vst, dht, hst, p, smem_bytes, prev, t0, t1, dst, mid0,
                       mid1, s);
  }
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
