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
// Every conv is conv3x3.cu's: a 3x3 SAME conv + bias, products and sums in
// fp32, the bias added in fp32, ReLU, one rounding to bf16; with round_sum
// the sum is rounded to bf16 before the bias (the serving graph's XLA conv
// followed by its bias add). The two skip additions are bf16 operations,
// each computed in fp32 and rounded to nearest even, as PyTorch and the JAX
// graph compute them.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s; published
// peaks): operations. The learned x2 trunk (tpu4b2, 270 x 480 grid, 6 convs
// 128 -> 128 and a tail 128 -> 256) needs 305.8 GFLOP, 0.309 ms, against
// 0.030 ms for its input, weights and output.
//
// Design: layer by layer over the whole frame, persistent, on conv3x3.cu's
// main loop. Keeping the chain on chip would need each tile's halo grown by
// the depth (a 16 x 16 tile's 7-layer window is 230 KB a layer, more than a
// block's 227 KB). Layer by layer over the whole frame needs no halo at all:
// the operations are exactly the trunk's, and one 128-channel activation of
// the x2 grid (270 x 480 x 128 bf16, 33.2 MB) fits in the 50 MB L2.
//  * One block of 256 threads (two warpgroups) per SM, launched with
//    cudaLaunchCooperativeKernel, so the blocks are co-resident or the launch
//    is refused (the caller gets the error; nothing falls back).
//  * Work items: layer l's are (image, 16 x 16 tile, 128-channel output
//    tile), item = (image * tiles + tile) * (Cout_l / 128) + channel tile.
//    The layers' items form one sequence, layer after layer, dealt
//    round-robin: block b takes items b, b + grid, ... of the sequence, so
//    a layer's last, partly filled round overlaps the next layer's first
//    (the x4 grid's 135 tiles on 132 SMs).
//  * Each item runs conv3x3_core.cuh's conv_tile as conv3x3.cu runs it (the
//    halo by cp.async with SAME's zeros, the swizzled weight ring, wgmma with
//    A by ldmatrix) and its stage_tile epilogue, then a 16-byte store loop
//    with the layer's ending: store; h + bf16(0.2) * c (bf16(0.2) * c
//    rounded, then the sum rounded); c + feat; the residual read at the same
//    positions with ld.global.cg.
//  * Activations are full-frame bf16 [N, H, W, cmid] buffers that the
//    caller allocates: feat, h and t. conv1 reads h and writes t, conv2 reads
//    t and writes h (the first block's conv2 reads its residual from feat
//    and writes h; later ones update h in place, each position read and
//    written by one thread), the trunk conv reads h (feat without blocks)
//    and writes t, the tail reads t and writes the output. Positions outside
//    the frame are never written or read: the halo load fills them with
//    zeros.
//  * Ready flags in place of a grid-wide barrier: a counter per (layer,
//    image, tile), and one per layer, which the caller zeroes. When an
//    item's tile is stored (every thread's stores, then __syncthreads),
//    thread 0 adds one to both with release adds. An item of layer l first
//    waits, one thread per neighbour by acquire loads, until the <= 9 tiles
//    of layer l - 1 under its halo are stored in every channel tile; once a
//    block has seen layer l - 1's counter complete it waits no more in layer
//    l. Waiting on the tiles under the halo also orders every overwrite
//    after the reads it replaces: a tile of layer l + 1 is written only
//    after the tiles of layer l around it, which in turn waited on layer
//    l - 1's within two tiles. The next layer's cp.async.cg and ld.global.cg
//    read through L2, so they see the other blocks' writes. No item waits
//    on a later one of the sequence, so the co-resident blocks always
//    progress (a spin that never ends traps instead of hanging).
//  * The layer's role (input, output, residual, weights, channels, ending)
//    sits in shared memory, read again after each main loop, so that little
//    beside conv_tile's own registers stays live across it.
// Each output of each conv is summed in conv3x3.cu's order, whatever the
// tile's place in the frame, and the epilogues round as the chain of
// conv3x3 launches and bf16 skip additions does: the kernel gives the bytes
// of trunk_chain(conv_cuda.conv3x3, ...).
//
// C interface: nu_trunk_fused launches on the caller's stream, allocates
// nothing (the caller passes the activations and the zeroed ready flags) and
// returns cudaGetLastError() of the launch, or the occupancy query's or the
// cooperative launch's error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "conv3x3_core.cuh"
#include "device_guard.cuh"

namespace {

using namespace nu_conv;

constexpr int kMaxLayers = 31;           // depth 3 + 2 * blocks, blocks <= 14
constexpr long long kSpinLimit = 1LL << 26;  // seconds of naps: a lost flag traps, not hangs

// What a layer's epilogue does with its bf16 result c at a frame position.
enum Ending {
  kStore = 0,       // dst = c
  kScaledSkip = 1,  // dst = resid + bf16(0.2) * c (a residual block's end)
  kSkip = 2,        // dst = c + resid (the trunk conv + feat)
};

struct Layers {
  const __nv_bfloat16* k[kMaxLayers];  // packed [cout_l, 3, 3, cin_l]
  const __nv_bfloat16* b[kMaxLayers];  // [cout_l]
};

struct Geometry {
  int n, h, w;  // batch, frame (the trunk grid)
  int cin, cmid, cout;
  int blocks, depth;
  int tiles_w, tiles;  // tiles per row, per image
};

struct Buffers {
  __nv_bfloat16* feat;
  __nv_bfloat16* hbuf;
  __nv_bfloat16* tbuf;
  __nv_bfloat16* out;
  // (depth - 1) * n * tiles counters per (layer, image, tile), then depth - 1
  // per layer, of every layer but the tail: the items stored; zero at launch
  unsigned int* ready;
};

// Spins until *flag >= want (an acquire load), trapping if it never comes.
__device__ __forceinline__ void wait_flag(const unsigned int* flag, unsigned int want) {
  long long spins = 0;
  while (true) {
    unsigned int seen;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(flag) : "memory");
    if (seen >= want) return;
    if (++spins > kSpinLimit) __trap();
    __nanosleep(64);
  }
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

// Layer l's part in the chain: its input, output, residual, weights, bias,
// channels and ending.
struct Role {
  const __nv_bfloat16* src;
  __nv_bfloat16* dst;
  const __nv_bfloat16* resid;
  const __nv_bfloat16* k;
  const __nv_bfloat16* b;
  int cin, cout, ending, relu;
};

__device__ __forceinline__ Role role_of(int l, const __nv_bfloat16* x, const Layers& layers,
                                        const Geometry& g, const Buffers& buf) {
  Role r{buf.tbuf, buf.tbuf, buf.feat, layers.k[l], layers.b[l], g.cmid, g.cmid, kStore, 0};
  if (l == 0) {  // head
    r.src = x;
    r.cin = g.cin;
    r.dst = buf.feat;
  } else if (l < g.depth - 2) {  // block (l - 1) / 2
    const bool first = l <= 2;
    if (l & 1) {  // conv1: relu(conv(h)) -> t
      r.src = first ? buf.feat : buf.hbuf;
      r.relu = 1;
    } else {  // conv2: h + bf16(0.2) * conv(t) -> h
      r.dst = buf.hbuf;
      r.resid = first ? buf.feat : buf.hbuf;
      r.ending = kScaledSkip;
    }
  } else if (l == g.depth - 2) {  // trunk: conv(h) + feat -> t
    r.src = g.blocks > 0 ? buf.hbuf : buf.feat;
    r.ending = kSkip;
  } else {  // tail -> out
    r.dst = buf.out;
    r.cout = g.cout;
  }
  return r;
}

template <int TH, int TW, int NS, bool ROUND_SUM>
__global__ void __launch_bounds__(kThreads, 1)
trunk_kernel(const __nv_bfloat16* __restrict__ x, const __grid_constant__ Layers layers,
             const __grid_constant__ Geometry g, const __grid_constant__ Buffers buf) {
  constexpr int kEpi = ROUND_SUM ? kRoundSum : kSingle;
  extern __shared__ unsigned char smem_raw[];
  // The layer's role and the flag of the block's last item live in shared
  // memory and are read again after each main loop.
  __shared__ Role role;
  __shared__ int s_role, s_done;  // the layer in `role`; the ready flag the last item sets, or -1
  __shared__ int s_known;          // the last layer this block has seen complete
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t halo = (raw + 1023u) & ~1023u;
  unsigned char* stage_out = smem_raw + (halo - raw);
  const int tid = threadIdx.x;
  const int per_layer = g.n * g.tiles;  // items of a layer of 128 output channels
  if (tid == 0) {
    s_role = -1;
    s_done = -1;
    s_known = -1;
  }
  // after the tile flags: one counter per layer, its items stored
  unsigned int* layer_done = buf.ready + static_cast<size_t>(g.depth - 1) * per_layer;

  int l = 0, first = 0;  // the layer of item `seq` and that layer's first index
  for (int seq = blockIdx.x;; seq += gridDim.x) {
    while (l < g.depth && seq >= first + per_layer * ((l == g.depth - 1 ? g.cout : g.cmid) / kBN)) {
      first += per_layer * ((l == g.depth - 1 ? g.cout : g.cmid) / kBN);
      ++l;
    }
    __syncthreads();  // the previous item is stored by every thread; its role is read
    if (tid == 0) {
      if (s_done >= 0) {  // the previous item's tile is ready for the next layer
        asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                     ::"l"(buf.ready + s_done), "r"(1u) : "memory");
        asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                     ::"l"(layer_done + s_done / per_layer), "r"(1u) : "memory");
      }
      if (l < g.depth && l != s_role) {
        role = role_of(l, x, layers, g, buf);
        s_role = l;
      }
    }
    if (l == g.depth) break;
    float acc[2][64];
    {
      const int it = seq - first;
      const int nct = (l == g.depth - 1 ? g.cout : g.cmid) / kBN;
      const int t = it / nct;
      const int img = t / g.tiles, tile = t - img * g.tiles;
      const int ty = tile / g.tiles_w, tx = tile - ty * g.tiles_w;
      // wait until layer l - 1 has stored every tile under this one's halo
      // (once the block has seen all of layer l - 1 stored, no more)
      if (l > 0 && s_known < l - 1) {
        if (tid < 9) {
          const int ny = ty + tid / 3 - 1, nx = tx + tid % 3 - 1;
          if (ny >= 0 && nx >= 0 && nx < g.tiles_w && ny * g.tiles_w + nx < g.tiles) {
            const size_t flag = static_cast<size_t>(l - 1) * per_layer + img * g.tiles + ny * g.tiles_w + nx;
            wait_flag(buf.ready + flag, g.cmid / kBN);
          }
        } else if (tid == 32) {  // has all of layer l - 1 been stored?
          unsigned int seen;
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                       : "=r"(seen) : "l"(layer_done + l - 1) : "memory");
          if (seen == static_cast<unsigned int>(per_layer * (g.cmid / kBN))) s_known = l - 1;
        }
      }
      __syncthreads();  // the role is written; the tiles under the halo are ready
      const size_t base = static_cast<size_t>(img) * g.h * g.w;
      conv_tile<TH, TW, NS>(halo, role.src + base * role.cin, role.k, g.h, g.w, role.cin, ty * TH,
                            tx * TW, (it - t * nct) * kBN, acc);
    }
    // the item's place again, from the role read after the main loop
    const int cout_l = role.cout, nct = cout_l / kBN, ending = role.ending;
    const int it = seq - first;
    const int t = it / nct;
    const int n0 = (it - t * nct) * kBN;
    const int img = t / g.tiles, tile = t - img * g.tiles;
    const int y0 = (tile / g.tiles_w) * TH, x0 = (tile % g.tiles_w) * TW;
    const size_t base = static_cast<size_t>(img) * g.h * g.w;
    if (role.relu) {
      stage_tile<true, kEpi>(acc, stage_out, role.b, nullptr, n0);
    } else {
      stage_tile<false, kEpi>(acc, stage_out, role.b, nullptr, n0);
    }
    __nv_bfloat16* dst = role.dst;
    const __nv_bfloat16* resid = role.resid;
    const float c02 = __bfloat162float(__float2bfloat16_rn(0.2f));
    for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
      const int m = i >> 4, v = i & 15;
      const int gy = y0 + m / TW, gx = x0 + m % TW;
      if (gy >= g.h || gx >= g.w) continue;
      const size_t pos = base + static_cast<size_t>(gy) * g.w + gx;
      uint4 c = *reinterpret_cast<const uint4*>(stage_out + m * kRowBytes + v * 16);
      if (ending != kStore) {
        const uint4 rv = __ldcg(reinterpret_cast<const uint4*>(resid + pos * g.cmid + n0 + v * 8));
        const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&rv);
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&c);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (ending == kScaledSkip) {
            const float scaled = bf(__float2bfloat16_rn(__fmul_rn(c02, bf(e[q]))));
            e[q] = __float2bfloat16_rn(__fadd_rn(bf(r[q]), scaled));
          } else {
            e[q] = __float2bfloat16_rn(__fadd_rn(bf(e[q]), bf(r[q])));
          }
        }
      }
      *reinterpret_cast<uint4*>(dst + pos * cout_l + n0 + v * 8) = c;
    }
    // set at the next item's start; the tail's output is read by no later layer
    if (tid == 0) s_done = l < g.depth - 1 ? l * per_layer + t : -1;
  }
}

template <int TH, int TW, int NS, bool ROUND_SUM>
int launch(const void* x, const Layers& layers, const Geometry& g, const Buffers& buf, int grid,
           cudaStream_t stream) {
  constexpr int smem = Layout<TH, TW, NS>::kSmem;
  const void* kernel = reinterpret_cast<const void*>(trunk_kernel<TH, TW, NS, ROUND_SUM>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  void* args[] = {static_cast<void*>(&xp), const_cast<Layers*>(&layers), const_cast<Geometry*>(&g),
                  const_cast<Buffers*>(&buf)};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ks: host array of `depth` device pointers to the layers' packed weights
// [cout_l, 3, 3, cin_l] (head, block convs, trunk, tail); bs: their bf16
// biases. feat, hbuf, tbuf: n * h * w * cmid bf16 each (cmid a multiple of
// 128); ready: (depth - 1) * (n * tiles + 1) zeroed uint32, tiles the 16 x
// 16 tiles of a frame (the conv's one tile, a ring of 4 weight stages); grid
// at most the co-resident blocks (one per SM). Returns 0 on success, else a
// cudaError_t code (see nu_cuda_error_string).
int nu_trunk_fused(int device, const void* x, const void* const* ks, const void* const* bs,
                   int depth, void* feat, void* hbuf, void* tbuf, void* ready, void* out, int n,
                   int h, int w, int cin, int cmid, int cout, int blocks, int grid,
                   int round_sum, void* stream) {
  if (depth != 3 + 2 * blocks || blocks < 0 || depth > kMaxLayers || n < 1 || h < 1 || w < 1 ||
      cin < kKC || cin % kKC || cmid < kBN || cmid % kBN || cout < kBN || cout % kBN ||
      grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.n = n;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cmid = cmid;
  g.cout = cout;
  g.blocks = blocks;
  g.depth = depth;
  g.tiles_w = (w + 15) / 16;
  g.tiles = g.tiles_w * ((h + 15) / 16);
  // every layer's items in one sequence, and a round of the grid past it
  if (static_cast<long long>(g.tiles) * n * ((depth - 1) * (cmid / kBN) + cout / kBN) + grid >
      0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layers layers;
  for (int l = 0; l < kMaxLayers; ++l) {
    layers.k[l] = l < depth ? static_cast<const __nv_bfloat16*>(ks[l]) : nullptr;
    layers.b[l] = l < depth ? static_cast<const __nv_bfloat16*>(bs[l]) : nullptr;
  }
  const Buffers buf{static_cast<__nv_bfloat16*>(feat), static_cast<__nv_bfloat16*>(hbuf),
                    static_cast<__nv_bfloat16*>(tbuf), static_cast<__nv_bfloat16*>(out),
                    static_cast<unsigned int*>(ready)};
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_sum ? launch<16, 16, 4, true>(x, layers, g, buf, grid, s)
                   : launch<16, 16, 4, false>(x, layers, g, buf, grid, s);
}

const char* nu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
