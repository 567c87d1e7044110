// The whole ESRGAN-lite trunk (head -> residual blocks -> trunk + skip ->
// tail) in one launch, bf16 on the tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel nu_scaler_tpu/kernels/conv_pallas.py:183
// make_trunk_fused (-> _trunk_kernel :123). What it computes (the function of
// trunk_cuda.trunk_fused_plain), on bf16 NHWC x [N, H, W, cin]:
//   feat = conv(head)(x)
//   h = feat; per block: h = h + bf16(0.2) * conv2(relu(conv1(h)))
//   h = conv(trunk)(h) + feat
//   out = conv(tail)(h)                                  bf16 [N, H, W, cout]
// Every conv is a 3x3 SAME conv + bias with the epilogue of conv3x3.cu:
// products and sums in fp32, the bias added in fp32, ReLU, one rounding to
// bf16; with round_sum the sum is rounded to bf16 before the bias (the
// serving graph's XLA conv followed by its bias add). The two skip additions
// are bf16 operations, each computed in fp32 and rounded to nearest even, as
// PyTorch and the JAX graph compute them. Every intermediate is zero outside
// the frame (SAME padding of the next conv); the tail is written only inside.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s; published
// peaks): operations. The learned x2 trunk (tpu4b2, 270 x 480 grid, 6 convs
// 128 -> 128 and a tail 128 -> 256) needs 305.8 GFLOP, 0.309 ms, against
// 0.030 ms for its input, weights and output.
//
// Design (a first one: simple and right, not fast). The chain does not fit
// on chip: one layer's 128-channel input window for a 16 x 16 output tile
// with the x2 trunk's 7-layer halo is 30 x 30 x 128 bf16 = 230,400 bytes,
// more than a block's 227 KB of shared memory before any weights.
//  * Each block owns a tile_h x tile_w output tile and recomputes its halo at
//    every layer: layer l (0-based, of depth d) computes the window of the
//    tile grown by d - 1 - l positions on every side.
//  * The windows live in global scratch, three per block (feat, the
//    residual h, and the block-internal / trunk output), each
//    win_h x win_w x cmid with win = tile + 2 (d - 1), addressed in one frame
//    of reference whose origin is the tile's origin minus d - 1. The blocks
//    are persistent (the grid is at most the card's resident block count) and
//    walk the tiles of the batch, so the scratch stays bounded. Scratch is
//    read with ld.global.cg (L2), after a __syncthreads that orders it after
//    the writes of the layer before.
//  * Each conv is an implicit GEMM on nvcuda::wmma 16x16x16 bf16 fragments
//    with fp32 accumulators (32-channel chunks of the input, taps 0..8, two
//    k-steps of 16): an 8 x 16-position sub-tile of the window x 128 output
//    channels per pass, its input with a one-position halo and the 9 taps'
//    weight slices staged in shared memory (95,616 bytes; two blocks per
//    SM). A wider layer (the tails: 256 and 1024 outputs) loops its channel
//    tiles of 128. conv3x3.cu sums in another order (warpgroup MMAs, tap by
//    tap over 16-channel steps), so the kernel and the chain of conv3x3
//    launches agree within trunk_cuda.ulp_tolerance, not bit for bit;
//    chip_smoke.py phase 3 prints the share of values that are equal.
//  * A sub-tile that lies wholly outside the frame is not computed: its
//    window positions are written as zeros.
//  * The skip additions happen in the epilogues of the block's second conv
//    (h + bf16(0.2) * c, in place on h) and of the trunk conv (+ feat).
// The halo costs operations: at the x2 grid with 16 x 32 tiles the sub-tiles
// computed are 2.1 times the trunk's own (the window's rounding to 8 x 16
// sub-tiles included). A design that keeps a row strip on chip across a
// thread-block cluster, or per-layer line buffers, is later work.
//
// C interface: nu_trunk_fused launches on the caller's stream, allocates
// nothing (the caller passes the scratch) and returns cudaGetLastError() of
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kTH = 8;                        // rows of a sub-tile
constexpr int kTW = 16;                       // columns of a sub-tile (one fragment's rows)
constexpr int kBM = kTH * kTW;                // positions of a sub-tile
constexpr int kBN = 128;                      // output channels of a pass
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
constexpr int kMaxLayers = 32;                // depth 3 + 2 * blocks, blocks <= 14
static_assert(kBM * kStLd * 4 <= kSmem, "the epilogue's staging must fit");
static_assert(kHaloBytes % 128 == 0, "weights must start 128-byte aligned");

// What a conv's epilogue does with its bf16 result c at a window position.
enum Epilogue {
  kStore = 0,       // dst = c
  kScaledSkip = 1,  // dst = resid + bf16(0.2) * c (a residual block's end)
  kSkip = 2,        // dst = c + resid (the trunk conv + feat)
  kOut = 3,         // the tail: c to the output frame, inside the frame only
};

struct Layers {
  const __nv_bfloat16* k[kMaxLayers];  // HWIO [3, 3, cin_l, cout_l]
  const __nv_bfloat16* b[kMaxLayers];  // [cout_l]
};

struct Geometry {
  int h, w;            // the frame (trunk grid)
  int cin, cmid, cout;
  int blocks, depth;
  int tile_h, tile_w;  // output tile
  int tiles_w, tiles;  // tiles per row, per image
  int win_h, win_w;    // the head's window: tile + 2 (depth - 1)
  int n;               // batch
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

// One 3x3 conv layer of the chain over its window: buffer rows and columns
// [layer, win - layer). `src` is the image of x (frame coordinates) for the
// head, else a scratch window; `dst` is a scratch window, or the image of the
// output for the tail.
template <bool ROUND_SUM>
__device__ __noinline__ void conv_layer(const Geometry& g, int layer, int oy, int ox,
                                        const __nv_bfloat16* src, bool from_x, int cin_l,
                                        const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ b, int cout_l, bool relu,
                                        int epi, const __nv_bfloat16* resid, __nv_bfloat16* dst) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wts = reinterpret_cast<__nv_bfloat16*>(smem + kHaloBytes);
  float* stage = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // sub-tile rows 2*wm, 2*wm + 1
  const int wn = warp >> 2;  // channels 64*wn .. 64*wn + 63
  const int r_end = g.win_h - layer, c_end = g.win_w - layer;
  const float c02 = __bfloat162float(__float2bfloat16_rn(0.2f));

  for (int n0 = 0; n0 < cout_l; n0 += kBN) {
    for (int sy = layer; sy < r_end; sy += kTH) {
      for (int sx = layer; sx < c_end; sx += kTW) {
        __syncthreads();  // the previous pass's staging and writes are done
        const int ay = oy + sy, ax = ox + sx;
        if (ay >= g.h || ay + kTH <= 0 || ax >= g.w || ax + kTW <= 0) {
          // wholly outside the frame: zeros (the tail writes nothing there)
          if (epi != kOut) {
            for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
              const int p = i / (kBN / 8), v = i % (kBN / 8);
              const int by = sy + p / kTW, bx = sx + p % kTW;
              if (by >= r_end || bx >= c_end) continue;
              *reinterpret_cast<uint4*>(
                  dst + (static_cast<size_t>(by) * g.win_w + bx) * g.cmid + n0 + v * 8) =
                  make_uint4(0u, 0u, 0u, 0u);
            }
          }
          continue;
        }

        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

        for (int c0 = 0; c0 < cin_l; c0 += kKC) {
          __syncthreads();  // the previous chunk's fragments are read
          // the input with a one-position halo, zero outside the frame
          for (int i = tid; i < kHaloPos * (kKC / 8); i += kThreads) {
            const int pos = i / (kKC / 8), v = i % (kKC / 8);
            const int by = sy - 1 + pos / kHaloW, bx = sx - 1 + pos % kHaloW;
            const int gy = oy + by, gx = ox + bx;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (gy >= 0 && gy < g.h && gx >= 0 && gx < g.w) {
              if (from_x) {
                val = __ldg(reinterpret_cast<const uint4*>(
                    src + (static_cast<size_t>(gy) * g.w + gx) * cin_l + c0 + v * 8));
              } else if (by >= 0 && by < g.win_h && bx >= 0 && bx < g.win_w) {
                val = __ldcg(reinterpret_cast<const uint4*>(
                    src + (static_cast<size_t>(by) * g.win_w + bx) * g.cmid + c0 + v * 8));
              }
            }
            *reinterpret_cast<uint4*>(halo + pos * kHaloLd + v * 8) = val;
          }
          // the weights: 9 taps x 32 input channels x 16 vectors of 8 outputs
          for (int i = tid; i < 9 * kKC * (kBN / 8); i += kThreads) {
            const int row = i / (kBN / 8), v = i % (kBN / 8);
            const int tap = row / kKC, c = row % kKC;
            *reinterpret_cast<uint4*>(wts + row * kWLd + v * 8) =
                __ldg(reinterpret_cast<const uint4*>(
                    k + (static_cast<size_t>(tap) * cin_l + c0 + c) * cout_l + n0 + v * 8));
          }
          __syncthreads();

#pragma unroll 1
          for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;
#pragma unroll
            for (int kk = 0; kk < kKC; kk += 16) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr[4];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int ty = 2 * wm + i;
                wmma::load_matrix_sync(a[i], halo + ((ty + dy) * kHaloW + dx) * kHaloLd + kk,
                                       kHaloLd);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                wmma::load_matrix_sync(bfr[j], wts + (tap * kKC + kk) * kWLd + wn * 64 + j * 16,
                                       kWLd);
              }
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
            }
          }
        }

        // epilogue: accumulators -> shared fp32 -> bias, ReLU, bf16, skip
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(stage + (2 * wm + i) * 16 * kStLd + wn * 64 + j * 16,
                                    acc[i][j], kStLd, wmma::mem_row_major);
          }
        __syncthreads();
        for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
          const int p = i / (kBN / 8), v = i % (kBN / 8);
          const int by = sy + p / kTW, bx = sx + p % kTW;
          if (by >= r_end || bx >= c_end) continue;  // past the window
          const int gy = oy + by, gx = ox + bx;
          const bool inside = gy >= 0 && gy < g.h && gx >= 0 && gx < g.w;
          if (epi == kOut && !inside) continue;
          const float* sum_at = stage + p * kStLd + v * 8;
          const __nv_bfloat16* bias = b + n0 + v * 8;
          __nv_bfloat16* at =
              epi == kOut
                  ? dst + (static_cast<size_t>(gy) * g.w + gx) * cout_l + n0 + v * 8
                  : dst + (static_cast<size_t>(by) * g.win_w + bx) * g.cmid + n0 + v * 8;
          __align__(16) __nv_bfloat16 res[8];
          if (!inside) {
#pragma unroll
            for (int e = 0; e < 8; ++e) res[e] = __float2bfloat16_rn(0.0f);
          } else {
            uint4 rv = make_uint4(0u, 0u, 0u, 0u);
            if (epi == kScaledSkip || epi == kSkip) {
              rv = __ldcg(reinterpret_cast<const uint4*>(
                  resid + (static_cast<size_t>(by) * g.win_w + bx) * g.cmid + n0 + v * 8));
            }
            const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&rv);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              float sum = sum_at[e];
              if (ROUND_SUM) sum = __bfloat162float(__float2bfloat16_rn(sum));
              float val = __fadd_rn(sum, bf(bias[e]));
              if (relu) val = fmaxf(val, 0.0f);
              __nv_bfloat16 c = __float2bfloat16_rn(val);
              if (epi == kScaledSkip) {
                const __nv_bfloat16 scaled = __float2bfloat16_rn(__fmul_rn(c02, bf(c)));
                c = __float2bfloat16_rn(__fadd_rn(bf(r[e]), bf(scaled)));
              } else if (epi == kSkip) {
                c = __float2bfloat16_rn(__fadd_rn(bf(c), bf(r[e])));
              }
              res[e] = c;
            }
          }
          *reinterpret_cast<uint4*>(at) = *reinterpret_cast<const uint4*>(res);
        }
      }
    }
  }
}

template <bool ROUND_SUM>
__global__ void __launch_bounds__(kThreads, 2)
trunk_kernel(const __nv_bfloat16* __restrict__ x, Layers layers, Geometry g,
             __nv_bfloat16* scratch, __nv_bfloat16* __restrict__ out) {
  const size_t window = static_cast<size_t>(g.win_h) * g.win_w * g.cmid;
  __nv_bfloat16* feat = scratch + static_cast<size_t>(blockIdx.x) * 3 * window;
  __nv_bfloat16* hbuf = feat + window;
  __nv_bfloat16* tbuf = hbuf + window;
  const int halo = g.depth - 1;

  for (int t = blockIdx.x; t < g.n * g.tiles; t += gridDim.x) {
    const int img = t / g.tiles, tile = t - img * g.tiles;
    // frame coordinates of the windows' origin
    const int oy = (tile / g.tiles_w) * g.tile_h - halo;
    const int ox = (tile % g.tiles_w) * g.tile_w - halo;
    const __nv_bfloat16* xi = x + static_cast<size_t>(img) * g.h * g.w * g.cin;

    conv_layer<ROUND_SUM>(g, 0, oy, ox, xi, true, g.cin, layers.k[0], layers.b[0], g.cmid,
                          false, kStore, nullptr, feat);
    const __nv_bfloat16* h = feat;
    for (int blk = 0; blk < g.blocks; ++blk) {
      const int l1 = 1 + 2 * blk, l2 = l1 + 1;
      conv_layer<ROUND_SUM>(g, l1, oy, ox, h, false, g.cmid, layers.k[l1], layers.b[l1], g.cmid,
                            true, kStore, nullptr, tbuf);
      conv_layer<ROUND_SUM>(g, l2, oy, ox, tbuf, false, g.cmid, layers.k[l2], layers.b[l2],
                            g.cmid, false, kScaledSkip, h, hbuf);
      h = hbuf;
    }
    const int lt = g.depth - 2, ll = g.depth - 1;
    conv_layer<ROUND_SUM>(g, lt, oy, ox, h, false, g.cmid, layers.k[lt], layers.b[lt], g.cmid,
                          false, kSkip, feat, tbuf);
    conv_layer<ROUND_SUM>(g, ll, oy, ox, tbuf, false, g.cmid, layers.k[ll], layers.b[ll], g.cout,
                          false, kOut, nullptr,
                          out + static_cast<size_t>(img) * g.h * g.w * g.cout);
  }
}

template <bool ROUND_SUM>
int launch(const void* x, const Layers& layers, const Geometry& g, void* scratch, void* out,
           int grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(trunk_kernel<ROUND_SUM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  trunk_kernel<ROUND_SUM><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), layers, g, static_cast<__nv_bfloat16*>(scratch),
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ks, bs: host arrays of `depth` device pointers (head, block convs, trunk,
// tail). scratch: grid * 3 * win_h * win_w * cmid bf16, win = tile + 2 (depth
// - 1). Returns 0 on success, else a cudaError_t code (see
// nu_cuda_error_string).
int nu_trunk_fused(int device, const void* x, const void* const* ks, const void* const* bs,
                   int depth, void* scratch, void* out, int n, int h, int w, int cin, int cmid,
                   int cout, int blocks, int tile_h, int tile_w, int grid, int round_sum,
                   void* stream) {
  if (depth != 3 + 2 * blocks || blocks < 0 || depth > kMaxLayers || n < 1 || h < 1 || w < 1 ||
      cin < kBN || cin % kBN || cmid < kBN || cmid % kBN || cout < kBN || cout % kBN ||
      tile_h < 1 || tile_w < 1 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cmid = cmid;
  g.cout = cout;
  g.blocks = blocks;
  g.depth = depth;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.tiles_w = (w + tile_w - 1) / tile_w;
  g.tiles = g.tiles_w * ((h + tile_h - 1) / tile_h);
  g.win_h = tile_h + 2 * (depth - 1);
  g.win_w = tile_w + 2 * (depth - 1);
  g.n = n;
  if (static_cast<long long>(g.tiles) * n > 0x7fffffffLL || grid > g.tiles * n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layers layers;
  for (int l = 0; l < kMaxLayers; ++l) {
    layers.k[l] = l < depth ? static_cast<const __nv_bfloat16*>(ks[l]) : nullptr;
    layers.b[l] = l < depth ? static_cast<const __nv_bfloat16*>(bs[l]) : nullptr;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_sum ? launch<true>(x, layers, g, scratch, out, grid, s)
                   : launch<false>(x, layers, g, scratch, out, grid, s);
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
