"""Wrapper of the fused trunk kernel (`csrc/trunk_fused.cu`) and its plain
PyTorch version.

`make_trunk_fused` replaces `nu_scaler_tpu/kernels/conv_pallas.py:183`
make_trunk_fused (→ `_trunk_kernel` :123): the whole ESRGAN-lite trunk in
one launch, bf16 NHWC ``[N, H, W, cin]`` → bf16 ``[N, H, W, cout]``::

    feat = conv(head)(x)
    h = feat; per block: h = h + bf16(0.2) · conv2(relu(conv1(h)))
    h = conv(trunk)(h) + feat
    out = conv(tail)(h)

Each conv is `conv_cuda.conv3x3`'s function (3×3 SAME, bias, fp32 sums, one
rounding to bf16, or with ``round_sum`` the serving graph's rounding of the
sum before a bf16 bias add), and the two skip additions are bf16 operations.
The Pallas kernel masks every intermediate to zero outside the frame; a SAME
conv sees exactly that, so the plain version is the chain of
`conv_cuda.conv3x3_plain` calls. ``params`` is the Pallas function's flat
tuple ``(head_k, head_b, [k1, b1, k2, b2]·blocks, trunk_k, trunk_b, tail_k,
tail_b)`` of HWIO bf16 kernels and bf16 biases. The TPU tiling arguments
(``th``, ``vmem_limit_mb``) have no counterpart: the kernel deals its own
work items (`plan`).

The kernel runs the layers one after another over the whole frame, each
tile of a layer waiting on the ready flags of the tiles of the layer before
under its halo, and each conv on `conv3x3.cu`'s main loop (the shared
`csrc/conv3x3_core.cuh`). It sums every output in that loop's
order, so it gives exactly the bytes of the chain of `conv3x3` launches,
`trunk_chain(conv_cuda.conv3x3, ...)`. The plain version sums in another
order (9 fp32 matmuls per conv), and a flipped rounding of one layer
travels through the layers after it, so kernel and plain version agree to
`TOL_ULPS` bf16 ulps of the output's largest magnitude (`ulp_tolerance`). A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises, a cooperative launch that the card refuses
included.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from nu_scaler_tpu_torch.kernels.conv_cuda import LANES, conv3x3_plain, pack_weights, ulp_bf16

# Launches since the last `reset_launches()`; the wrapper adds one where it
# launches its kernel and nowhere else.
launches = {"trunk_fused": 0}

# The bound of kernel against plain, in bf16 ulps of the output's largest
# magnitude (see `ulp_tolerance`). The kernel gives the chain of `conv3x3`
# launches' bytes, and that chain sums each conv in another order than the
# plain version. In the serving graph's raw domain a flipped rounding in an
# early layer reaches the tail (its weights carry the ×255) as several raw
# units: on the CPU, the plain chain with its sums taken in float64 (a
# stand-in for the kernel's order) moves the tpu4b2 / tpu4 trunks' output by
# up to 8 such ulps (a 16×32 grid), and on an NVIDIA H100 the kernel differs
# from the plain version by up to 14 (`chip_smoke.py` phase 3: the 270×480
# and 135×240 grids, the committed weights on a noise frame's s2d); on
# seeded weights by up to 1.
TOL_ULPS = 24
MAX_BLOCKS = 14  # the kernel's table holds 3 + 2·14 layers
TILE = 16  # the conv's tile: 16 × 16 output positions


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def depth(blocks: int) -> int:
    """Convs in the chain: head, two per block, trunk, tail."""
    return 3 + 2 * blocks


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def trunk_chain(conv, x: torch.Tensor, params: Sequence[torch.Tensor], blocks: int,
                round_sum: bool = False) -> torch.Tensor:
    """The trunk as one ``conv(x, k, b, relu, round_sum)`` call per layer, the
    skip additions in bf16 (the serving graph's "layers" chain)."""
    c02 = torch.tensor(0.2, dtype=torch.bfloat16, device=x.device)  # bf16(0.2), as JAX's
    feat = conv(x, params[0], params[1], False, round_sum)
    h = feat
    for i in range(blocks):
        k1, b1, k2, b2 = params[2 + 4 * i: 6 + 4 * i]
        t1 = conv(h, k1, b1, True, round_sum)
        h = h + c02 * conv(t1, k2, b2, False, round_sum)
    trunk_k, trunk_b, tail_k, tail_b = params[2 + 4 * blocks:]
    h = conv(h, trunk_k, trunk_b, False, round_sum) + feat
    return conv(h, tail_k, tail_b, False, round_sum)


def trunk_fused_plain(x: torch.Tensor, params: Sequence[torch.Tensor], blocks: int,
                      round_sum: bool = False) -> torch.Tensor:
    """The kernel's function as a chain of `conv3x3_plain` calls: bf16
    [N, H, W, cin] → bf16 [N, H, W, cout]."""
    return trunk_chain(conv3x3_plain, x, params, blocks, round_sum)


def ulp_tolerance(plain: torch.Tensor) -> torch.Tensor:
    """The bound of kernel against plain, for every element: `TOL_ULPS`
    bf16 ulps of the output's largest magnitude (an fp32 scalar)."""
    return TOL_ULPS * ulp_bf16(plain.float().abs().max())


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def check_params(x: torch.Tensor, params: Sequence[torch.Tensor], blocks: int) -> None:
    """Types, devices, contiguity and shapes of x and the flat params."""
    if not 0 <= blocks <= MAX_BLOCKS:
        raise ValueError(f"blocks must be in 0..{MAX_BLOCKS}, got {blocks}")
    n_layers = depth(blocks)
    if len(params) != 2 * n_layers:
        raise ValueError(f"params: expected {2 * n_layers} tensors for {blocks} blocks, "
                         f"got {len(params)}")
    for name, t in (("x", x), *((f"params[{i}]", p) for i, p in enumerate(params))):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: expected a bfloat16 torch.Tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"x: expected NHWC [N, H, W, cin], got {tuple(x.shape)}")
    c = x.shape[-1]
    for layer in range(n_layers):
        k, b = params[2 * layer], params[2 * layer + 1]
        if k.dim() != 4 or k.shape[:3] != (3, 3, c):
            raise ValueError(f"params[{2 * layer}]: expected HWIO [3, 3, {c}, Cout], "
                             f"got {tuple(k.shape)}")
        if tuple(b.shape) != (k.shape[-1],):
            raise ValueError(f"params[{2 * layer + 1}]: expected [{k.shape[-1]}], "
                             f"got {tuple(b.shape)}")
        if c % LANES:
            raise ValueError(f"the trunk kernel takes channels in multiples of {LANES}, got {c}")
        c = k.shape[-1]
        if layer < n_layers - 1 and c != params[0].shape[-1]:
            raise ValueError(f"layer {layer} gives {c} channels, the trunk carries "
                             f"{params[0].shape[-1]}")
    if c % LANES:
        raise ValueError(f"the trunk kernel takes channels in multiples of {LANES}, got {c}")


class TrunkPlan(NamedTuple):
    """The kernel's launch: tiles_h × tiles_w tiles of `TILE` × `TILE`
    output positions an image;
    per layer its output channels (`couts`) and its work items (`items`: n ·
    tiles · couts[l] / 128), which follow each other in one sequence; `grid`
    persistent blocks; `flags` zeroed uint32 ready counters, one per (layer,
    image, tile) and one per layer of every layer but the tail; and the bf16
    elements of each of the three activation buffers (feat, h, t: n · h · w
    · cmid)."""

    n: int
    tiles_h: int
    tiles_w: int
    couts: tuple
    items: tuple
    grid: int
    flags: int
    act_elems: int


def plan(n: int, h: int, w: int, blocks: int, cmid: int, cout: int, sms: int) -> TrunkPlan:
    """The launch of the trunk kernel on `sms` streaming multiprocessors (one
    block each). The grid is the SM count, or fewer where the layers have
    fewer items in all."""
    tiles_h, tiles_w = -(-h // TILE), -(-w // TILE)
    d = depth(blocks)
    couts = tuple(cout if layer == d - 1 else cmid for layer in range(d))
    items = tuple(n * tiles_h * tiles_w * (c // LANES) for c in couts)
    return TrunkPlan(n, tiles_h, tiles_w, couts, items,
                     min(sms, sum(items)), (d - 1) * (n * tiles_h * tiles_w + 1), n * h * w * cmid)


def pack_params(params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Every layer's HWIO kernel repacked to ``[Cout, 3, 3, Cin]``
    (`conv_cuda.pack_weights`, the conv kernel's B operand), one copy each."""
    return [pack_weights(k) for k in params[0::2]]


def _launch(x: torch.Tensor, params: Sequence[torch.Tensor], blocks: int,
            round_sum: bool) -> torch.Tensor:
    """One cooperative launch on the weights repacked by `pack_params`."""
    if x.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")
    from nu_scaler_tpu_torch.kernels import _build

    lib = _build.load_library("trunk_fused")
    n, h, w, cin = x.shape
    cmid, cout = params[0].shape[-1], params[-1].shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p = plan(n, h, w, blocks, cmid, cout, sms)
    packed = pack_params(params)
    acts = torch.empty((3, p.act_elems), dtype=torch.bfloat16, device=x.device)
    ready = torch.zeros(p.flags, dtype=torch.int32, device=x.device)
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=x.device)
    n_layers = depth(blocks)
    ks = (ctypes.c_void_p * n_layers)(*(k.data_ptr() for k in packed))
    bs = (ctypes.c_void_p * n_layers)(*(params[2 * i + 1].data_ptr() for i in range(n_layers)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.nu_trunk_fused(
        x.device.index or 0, x.data_ptr(), ks, bs, n_layers,
        acts[0].data_ptr(), acts[1].data_ptr(), acts[2].data_ptr(), ready.data_ptr(),
        out.data_ptr(), n, h, w, cin, cmid, cout, blocks, p.grid, int(round_sum), stream,
    )
    if err != 0:
        raise RuntimeError(f"trunk_fused launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})")
    return out


def trunk_fused(x: torch.Tensor, params: Sequence[torch.Tensor], blocks: int,
                round_sum: bool = False) -> torch.Tensor:
    """bf16 [N, H, W, cin] → bf16 [N, H, W, cout]: the whole trunk, one launch
    (batch on the grid)."""
    check_params(x, params, blocks)
    if x.device.type == "cpu":
        return trunk_fused_plain(x, params, blocks, round_sum)
    out = _launch(x, params, blocks, round_sum)
    launches["trunk_fused"] += 1
    return out


def make_trunk_fused(h: int, w: int, cin: int, cmid: int, cout: int, blocks: int):
    """``fn(x [N, h, w, cin], params, round_sum=False) → [N, h, w, cout]``,
    bf16, or None when a channel count is not a multiple of 128 (the Pallas
    function's rule)."""
    if cin % LANES or cmid % LANES or cout % LANES:
        return None

    def fn(x: torch.Tensor, params: Sequence[torch.Tensor], round_sum: bool = False):
        if x.dim() != 4 or tuple(x.shape[1:]) != (h, w, cin):
            raise ValueError(f"x: expected [N, {h}, {w}, {cin}], got {tuple(x.shape)}")
        if params[0].shape[-1] != cmid or params[-1].shape[0] != cout:
            raise ValueError(f"params: expected {cmid} trunk and {cout} tail channels")
        return trunk_fused(x, params, blocks, round_sum)

    return fn
