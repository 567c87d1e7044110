"""Frame interpolation ops of the port: the counterpart of
`nu_scaler_tpu/ops/interpolate.py` for the zero-flow cross-fade ("blend"),
the production motion-compensated mode ("flow_soft"), its learned
refinement ("flow_soft_ref"), the hard block warp ("flow") and the
per-pixel warp ("flow_exact").

flow_soft, per frame pair (u8 [H, W, 4] × 2):

    luma pyramid (4 levels)  →  Horn–Schunck (HS) at the coarsest level
    →  one refinement level per step up to `base_level` (block warp of B by
    the upsampled flow + HS on the residual)  →  per-tile mean motion
    →  the overlapped-tile soft warp kernel (`kernels/soft_warp_cuda.py`).

A frame that the warp tile does not divide (or that holds fewer than 2×2
tiles) takes the JAX package's ragged branch instead: full-resolution flow,
then the overlapped soft warp of `warp_blend_soft` in plain PyTorch, with the
JAX function's bf16 slabs and accumulators.

flow: the same luma pyramid and HS down to full resolution (8 residual
iterations a level, `compute_flow_fast`), then RGB block-warped by −t·flow
and (1 − t)·flow (each tile's nearest of the K = 8 most common integer
offsets, one bilinear lerp) and mixed, alpha cross-faded
(`warp_blend_fast`).

flow_exact: an RGBA Gaussian pyramid, HS at the coarsest level and 4
iterations of residual refinement a level with the warp recomputed inside
every iteration (`compute_flow`), then a per-pixel bilinear warp of both
frames (`warp_blend`): the reference's designed path and its goldens.

The flow stages and both warps of "flow" and "flow_exact" were plain XLA in
the JAX package and are plain PyTorch here: elementwise ops, gathers and
small sums, all fp32 and none a matmul or a convolution, so the caller's
TF32 settings cannot reach them. The soft warp is the one CUDA kernel of
these modes.

flow_soft_ref: the flow_soft mid, then the learned refinement net
(`models/interp_refine.py`, its four convs on the conv kernel) on (A, B,
mid), where `refine_serves` (both sides multiples of 4); elsewhere the plain
flow_soft mid, as in the JAX package. `make_refined_mid_upscaler` and
`make_refined_multi_upscaler` resample the refined mid(s) to the output size
in the same call (`make_resampler`). The JAX package folds the net's phases
into its banded resample matmuls there, to spare the TPU a relayout; the
port resamples the refined mid itself, so it has one path.

`calibrated_step_ms` and `stage_timings_ms` time a mode's step and its
stages on the device (`utils/tracing.device_timer`), for the API's
`get_last_gpu_duration_ms`.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.kernels.soft_warp_cuda import candidates, frame_inputs, soft_warp_blend
from nu_scaler_tpu_torch.models import interp_refine
from nu_scaler_tpu_torch.ops.resample import (
    apply_taps,
    device_taps,
    make_resampler,
    resize_f32,
    to_device_u8,
)
from nu_scaler_tpu_torch.utils.tracing import device_timer

MODES = ("blend", "flow", "flow_soft", "flow_soft_ref", "flow_exact")

# The JAX package's constants (nu_scaler_tpu/ops/interpolate.py:40-44, 389-398).
DEFAULT_LAMBDA = 0.1
DEFAULT_ALPHA = 0.1
DEFAULT_COARSE_ITERS = 32
DEFAULT_REFINE_ITERS = 4
DEFAULT_PYRAMID_LEVELS = 4
WARP_TILE = (8, 128)
WARP_RANGE = 48  # max |motion| in pixels the block warp honors
WARP_K = 8  # candidate offsets of the block warp
SOFT_WARP_K = 4  # candidate offsets of the production soft warp


def blend_only(frame_a: torch.Tensor, frame_b: torch.Tensor, time_t: float) -> torch.Tensor:
    """Zero-flow cross-fade, u8 in → u8 out (rgba8unorm round packing):
    the arithmetic of `nu_scaler_tpu/ops/interpolate.py` blend_only in fp32,
    ((a + (b − a)·t) · (1/255)) · 255 rounded half to even."""
    a = frame_a.to(torch.float32)
    b = frame_b.to(torch.float32)
    t = torch.tensor(time_t, dtype=torch.float32, device=a.device)
    inv = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=a.device)
    out = (a + (b - a) * t) * inv
    return torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown interpolation mode: {mode!r}")


# ---------------------------------------------------------------------------
# pyramids
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _shift_index(n: int, d: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device).add_(d).clamp_(0, n - 1)


def _shift_edge(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """``out[i] = x[clip(i + d, 0, n − 1)]`` along `dim`."""
    if d == 0:
        return x
    return x.index_select(dim, _shift_index(x.shape[dim], d, x.device))


def luminance(rgba: torch.Tensor) -> torch.Tensor:
    """(r + g + b) · 0.33333 (horn_schunck.wgsl:18-21)."""
    return (rgba[..., 0] + rgba[..., 1] + rgba[..., 2]) * 0.33333


_BLUR = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # 1-4-6-4-1 / 16, exact in fp32


def _blur5(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The 5-tap blur along `dim`, clamped edges, taps summed in order."""
    out = _shift_edge(x, -2, dim) * _BLUR[0]
    for k in range(1, 5):
        out = out + _shift_edge(x, k - 2, dim) * _BLUR[k]
    return out


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap 1-4-6-4-1/16 blur of [..., H, W, C], clamped edges:
    columns, then rows."""
    return _blur5(_blur5(img, -2), -3)


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2×2 average of [..., H, W, C] to floor(size / 2)."""
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = h // 2, w // 2
    v = img[..., : oh * 2, : ow * 2, :]
    v = v.reshape(*v.shape[:-3], oh, 2, ow, 2, v.shape[-1])
    return v.mean(dim=(-2, -4))


def build_pyramid(img_f: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Gaussian pyramid of [..., H, W, C] fp32: level 0 the frame, each next
    blur → 2× downsample; stops early when a side is below 4."""
    pyr = [img_f]
    for _ in range(levels - 1):
        if pyr[-1].shape[-3] < 4 or pyr[-1].shape[-2] < 4:
            break  # a further halving would degenerate (tiny frames)
        pyr.append(downsample2x(gaussian_blur(pyr[-1])))
    return pyr


def pyramid_step_matrix(in_size: int) -> np.ndarray:
    """Dense [in//2, in] float32 matrix of one pyramid level along one axis:
    the 2:1 average decimation ∘ the 5-tap 1-4-6-4-1/16 blur with clamped
    edges (the formula of the JAX `_pyramid_step_matrix`). Each row has 6
    taps, (1, 5, 10, 10, 5, 1)/32 away from the edges."""
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16.0
    blur = np.zeros((in_size, in_size), np.float32)
    idx = np.arange(in_size)
    for j, kk in enumerate(k):
        np.add.at(blur, (idx, np.clip(idx + j - 2, 0, in_size - 1)), kk)
    half = in_size // 2
    avg = np.zeros((half, in_size), np.float32)
    avg[np.arange(half), np.arange(half) * 2] = 0.5
    avg[np.arange(half), np.arange(half) * 2 + 1] = 0.5
    return (avg @ blur).astype(np.float32)


def pyramid_step(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One pyramid level along `dim`: blur + 2:1 decimation to size//2."""
    return apply_taps(x, device_taps(x.device, pyramid_step_matrix, x.shape[dim]), dim)


def build_luma_pyramid(frame_u8: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Luma-first pyramid: one [H, W] fp32 plane per level, rows then
    columns at each step; stops early when a side is below 4."""
    f = frame_u8.to(torch.float32) * (1.0 / 255.0)
    pyr = [luminance(f)]
    for _ in range(levels - 1):
        cur = pyr[-1]
        if cur.shape[-2] < 4 or cur.shape[-1] < 4:
            break  # a further halving would degenerate (tiny frames)
        pyr.append(pyramid_step(pyramid_step(cur, -2), -1))
    return pyr


# ---------------------------------------------------------------------------
# Horn–Schunck
# ---------------------------------------------------------------------------


def _box3_avg(flow: torch.Tensor) -> torch.Tensor:
    """3×3 clamped box average (center included) of planar [..., h, w]."""
    rows = _shift_edge(flow, -1, -2) + flow + _shift_edge(flow, 1, -2)
    total = _shift_edge(rows, -1, -1) + rows + _shift_edge(rows, 1, -1)
    return total / 9.0


def _gradients(lum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central differences, x±1 and y±1 clamped to the plane."""
    ix = (_shift_edge(lum, 1, -1) - _shift_edge(lum, -1, -1)) * 0.5
    iy = (_shift_edge(lum, 1, -2) - _shift_edge(lum, -1, -2)) * 0.5
    return ix, iy


def horn_schunck(lum1: torch.Tensor, lum2: torch.Tensor, flow0: torch.Tensor, iters: int,
                 lam: float = DEFAULT_LAMBDA) -> torch.Tensor:
    """`iters` Jacobi iterations of the coarse HS update (smoothness `lam`);
    flow [h, w, 2] (x, y) in and out. Gradients and It are hoisted out of
    the loop; the loop runs on the planar [2, h, w] flow."""
    ix, iy = _gradients(lum1)
    it = lum2 - lum1
    denom = lam + ix * ix + iy * iy
    f = flow0.permute(2, 0, 1)
    for _ in range(iters):
        avg = _box3_avg(f)
        common = (ix * avg[0] + iy * avg[1] + it) / denom
        f = torch.stack((avg[0] - common * ix, avg[1] - common * iy))
    return f.permute(1, 2, 0)


def flow_upsample(flow: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Center-aligned bilinear resize of a flow field [h, w, 2]; the vectors
    are not rescaled (the caller applies ×2)."""
    return resize_f32(flow, out_h, out_w, "bilinear_center")


def _grid(h: int, w: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Column and row index planes [h, w], fp32."""
    gx = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    gy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return gx, gy


def flow_refine(lum1: torch.Tensor, lum2: torch.Tensor, flow: torch.Tensor, iters: int,
                alpha: float = DEFAULT_ALPHA, subpixel: bool = True) -> torch.Tensor:
    """Residual HS refinement at one pyramid level (flow [h, w, 2]): each
    iteration warps `lum2` by the current flow and recomputes It from it,
    then takes the update grad·(grad·f + It) / (α² + |grad|²), guarded
    where the denominator is ≤ 1e-6, and adds α times the 4-neighbour
    Laplacian. subpixel=True samples the warp bilinearly at texel centres;
    False truncates to integer coordinates (the WGSL's semantics)."""
    h, w = lum1.shape[-2], lum1.shape[-1]
    ix, iy = _gradients(lum1)
    den = alpha * alpha + ix * ix + iy * iy
    valid = den.abs() > 1e-6
    gx, gy = _grid(h, w, lum1.device)
    lum2c = lum2[..., None]  # channel dim for the bilinear sampler
    f = flow
    for _ in range(iters):
        if subpixel:
            warped = _sample_bilinear(lum2c, gx + f[..., 0] + 0.5, gy + f[..., 1] + 0.5)[..., 0]
            it = warped - lum1
        else:
            wx = torch.clamp(gx + f[..., 0], 0, w - 1).to(torch.int64)
            wy = torch.clamp(gy + f[..., 1], 0, h - 1).to(torch.int64)
            it = lum2[wy, wx] - lum1
        num = ix * f[..., 0] + iy * f[..., 1] + it
        scale = torch.where(valid, num / den, 0.0)
        lap_rows = _shift_edge(f, 1, -3) + _shift_edge(f, -1, -3)
        lap_cols = _shift_edge(f, 1, -2) + _shift_edge(f, -1, -2)
        lap = (lap_rows + lap_cols) * 0.25 - f
        upd = torch.stack((scale * ix, scale * iy), dim=-1)
        f = f - upd + alpha * lap
    return f


# ---------------------------------------------------------------------------
# the per-pixel warp (flow_exact)
# ---------------------------------------------------------------------------


def _sample_bilinear(img_f: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Bilinear clamp-to-edge sample of [H, W, C] at continuous texel
    coordinates (centres at k + 0.5): floor, then each of the four corner
    indices clamped on its own (the wgpu sampler)."""
    h, w = img_f.shape[-3], img_f.shape[-2]
    fx = xs - 0.5
    fy = ys - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    dx = (fx - x0)[..., None]
    dy = (fy - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    x0c, x1c = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    y0c, y1c = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    c00 = img_f[y0c, x0c]
    c10 = img_f[y0c, x1c]
    c01 = img_f[y1c, x0c]
    c11 = img_f[y1c, x1c]
    c0 = c00 + dx * (c10 - c00)
    c1 = c01 + dx * (c11 - c01)
    return c0 + dy * (c1 - c0)


def warp_blend(frame_a: torch.Tensor, frame_b: torch.Tensor, flow: torch.Tensor,
               time_t: float) -> torch.Tensor:
    """Motion-compensated blend, u8 [H, W, 4] × 2 + flow [H, W, 2] → u8: A
    sampled at p + 0.5 − t·flow, B at p + 0.5 + (1 − t)·flow, mixed by t,
    rounded half to even (rgba8unorm packing)."""
    h, w = frame_a.shape[-3], frame_a.shape[-2]
    a = frame_a.to(torch.float32) * (1.0 / 255.0)
    b = frame_b.to(torch.float32) * (1.0 / 255.0)
    gx, gy = _grid(h, w, a.device)
    gx, gy = gx + 0.5, gy + 0.5
    t = torch.tensor(time_t, dtype=torch.float32, device=a.device)
    c0 = _sample_bilinear(a, gx - t * flow[..., 0], gy - t * flow[..., 1])
    c1 = _sample_bilinear(b, gx + (1.0 - t) * flow[..., 0], gy + (1.0 - t) * flow[..., 1])
    out = c0 + (c1 - c0) * t
    return torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# tiles and the block warp
# ---------------------------------------------------------------------------


def _tile_mean(field: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Mean of each whole th×tw tile of [H, W, ...]; a ragged edge is cut."""
    h, w = field.shape[0], field.shape[1]
    ty, tx = h // th, w // tw
    v = field[: ty * th, : tx * tw]
    return v.reshape(ty, th, tx, tw, *field.shape[2:]).mean(dim=(1, 3))


def _tile_to_pixels(tiles: torch.Tensor, th: int, tw: int, h: int, w: int) -> torch.Tensor:
    """[Ty, Tx, ...] → [H, W, ...] by block replication; a ragged edge
    repeats the last tile row / column."""
    ty, tx = tiles.shape[0], tiles.shape[1]
    rows = (torch.arange(h, device=tiles.device) // th).clamp(max=ty - 1)
    cols = (torch.arange(w, device=tiles.device) // tw).clamp(max=tx - 1)
    return tiles[rows][:, cols]


def block_warp_planar(
    img_p: torch.Tensor, offset_field: torch.Tensor, k: int = WARP_K, rng: int = WARP_RANGE,
    tile: tuple = WARP_TILE, row0: int = 0, rows: int | None = None,
) -> torch.Tensor:
    """Sample planar `img_p` [C, H, W] f32 at p + offset(p), block-quantized:
    the top-K integer offsets of the tile means, each tile's nearest one, one
    gather of the candidate-shifted image and one bilinear lerp with the
    tile's fractions. As in the JAX function, the lerp reads the +1
    neighbour under the pixel's own tile's offset even across a tile border
    (the 1-px "lerp after select" approximation). Output rows row0 ..
    row0 + rows − 1 (all by default), each as in the whole frame's result."""
    c, h, w = img_p.shape
    rows = h - row0 if rows is None else rows
    band = slice(row0, row0 + rows)
    if tuple(offset_field.shape[:2]) != (h, w):
        raise ValueError(
            f"offset_field {tuple(offset_field.shape[:2])} must match image [H, W] ({h}, {w})"
        )
    th, tw = min(tile[0], h), min(tile[1], w)
    tiles = torch.clamp(_tile_mean(offset_field, th, tw), -rng, rng)
    cand_y, cand_x, assign = candidates(tiles, k, rng)
    chosen_y, chosen_x = cand_y[assign], cand_x[assign]
    fry = torch.clamp(tiles[..., 1] - chosen_y, 0.0, 1.0)
    frx = torch.clamp(tiles[..., 0] - chosen_x, 0.0, 1.0)
    fry_px = _tile_to_pixels(fry, th, tw, h, w)[band]
    frx_px = _tile_to_pixels(frx, th, tw, h, w)[band]
    # the candidate-shifted image on the (h+1)×(w+1) grid, edge-clamped
    assign_pad = _tile_to_pixels(assign, th, tw, h + 1, w + 1)[row0 : row0 + rows + 1]
    grid_rows = torch.arange(row0, row0 + rows + 1, device=img_p.device)[:, None]
    src_rows = (grid_rows + cand_y[assign_pad]).clamp(0, h - 1)
    cols = (torch.arange(w + 1, device=img_p.device)[None, :] + cand_x[assign_pad]).clamp(0, w - 1)
    combined = img_p[:, src_rows, cols]
    top_row = combined[:, :rows, :w] + frx_px * (combined[:, :rows, 1:] - combined[:, :rows, :w])
    bot_row = combined[:, 1:, :w] + frx_px * (combined[:, 1:, 1:] - combined[:, 1:, :w])
    return top_row + fry_px * (bot_row - top_row)


def block_warp(img_f: torch.Tensor, offset_field: torch.Tensor, k: int = WARP_K,
               rng: int = WARP_RANGE) -> torch.Tensor:
    """Channel-minor wrapper over `block_warp_planar` ([H, W, C] in and out)."""
    return block_warp_planar(img_f.permute(2, 0, 1), offset_field, k, rng).permute(1, 2, 0)


# ---------------------------------------------------------------------------
# flow
# ---------------------------------------------------------------------------


def compute_flow_fast(
    frame_a: torch.Tensor,
    frame_b: torch.Tensor,
    levels: int = DEFAULT_PYRAMID_LEVELS,
    coarse_iters: int = DEFAULT_COARSE_ITERS,
    refine_iters: int = 8,
    lam: float = DEFAULT_LAMBDA,
    base_level: int = 0,
    upsample: bool = True,
) -> torch.Tensor:
    """Coarse-to-fine flow (x, y) A→B without per-pixel gathers: HS at the
    coarsest luma level, then per finer level down to `base_level`, B
    block-warped toward A by the upsampled flow and `refine_iters` HS
    iterations on the residual. With ``base_level > 0`` the field is
    upsampled to full resolution (vectors scaled by 2**base_level), unless
    ``upsample=False`` returns it in base-level pixel units."""
    full_h, full_w = frame_a.shape[-3], frame_a.shape[-2]
    lums_a = build_luma_pyramid(frame_a, levels)
    lums_b = build_luma_pyramid(frame_b, levels)
    levels = len(lums_a)  # tiny frames: the pyramid stops before degenerating
    base_level = min(base_level, levels - 1)

    flow = torch.zeros(*lums_a[-1].shape, 2, dtype=torch.float32, device=frame_a.device)
    flow = horn_schunck(lums_a[-1], lums_b[-1], flow, coarse_iters, lam)
    for lvl in range(levels - 2, base_level - 1, -1):
        th, tw = lums_a[lvl].shape[-2], lums_a[lvl].shape[-1]
        flow = flow_upsample(flow, th, tw) * 2.0
        b_warp = block_warp_planar(lums_b[lvl][None], flow)[0]
        flow = flow + horn_schunck(lums_a[lvl], b_warp, torch.zeros_like(flow), refine_iters, lam)
    if base_level > 0 and upsample:
        flow = flow_upsample(flow, full_h, full_w) * float(2**base_level)
    return flow


def compute_flow(
    frame_a: torch.Tensor,
    frame_b: torch.Tensor,
    levels: int = DEFAULT_PYRAMID_LEVELS,
    coarse_iters: int = DEFAULT_COARSE_ITERS,
    refine_iters: int = DEFAULT_REFINE_ITERS,
    lam: float = DEFAULT_LAMBDA,
    alpha: float = DEFAULT_ALPHA,
) -> torch.Tensor:
    """Coarse-to-fine flow A→B in pixels at full resolution, the reference's
    designed path: RGBA Gaussian pyramids, HS at the coarsest level, then
    per finer level a bilinear 2× upsample, ×2, and `refine_iters`
    iterations of `flow_refine`."""
    a = frame_a.to(torch.float32) * (1.0 / 255.0)
    b = frame_b.to(torch.float32) * (1.0 / 255.0)
    lums_a = [luminance(p) for p in build_pyramid(a, levels)]
    lums_b = [luminance(p) for p in build_pyramid(b, levels)]
    levels = len(lums_a)  # tiny frames: the pyramid stops before degenerating

    flow = torch.zeros(*lums_a[-1].shape, 2, dtype=torch.float32, device=a.device)
    flow = horn_schunck(lums_a[-1], lums_b[-1], flow, coarse_iters, lam)
    for lvl in range(levels - 2, -1, -1):
        th, tw = lums_a[lvl].shape[-2], lums_a[lvl].shape[-1]
        flow = flow_upsample(flow, th, tw) * 2.0
        flow = flow_refine(lums_a[lvl], lums_b[lvl], flow, refine_iters, alpha)
    return flow


def flow_base_level(height: int, tile: tuple) -> int:
    """The production rule of `flow_tiles_fast`: quarter-resolution flow
    (level 2) at ≥720 rows when the tile divides by 4, else half (level 1)."""
    th, tw = tile
    return 2 if height >= 720 and th % 4 == 0 and tw % 4 == 0 else 1


def flow_tiles_fast(frame_a: torch.Tensor, frame_b: torch.Tensor, tile: tuple = WARP_TILE) -> torch.Tensor:
    """Per-tile mean motion [H/th, W/tw, 2] in full-resolution pixels, from
    the flow at the base level (no full-resolution flow is formed): the mean
    over (th/s, tw/s) base-level tiles, times s = 2**base_level."""
    th, tw = tile
    base_level = flow_base_level(frame_a.shape[-3], tile)
    s = 2**base_level
    base = compute_flow_fast(frame_a, frame_b, base_level=base_level, upsample=False)
    return _tile_mean(base, th // s, tw // s) * float(s)


def warp_blend_fast(frame_a: torch.Tensor, frame_b: torch.Tensor, flow: torch.Tensor,
                    time_t: float, tile: tuple = WARP_TILE, row0: int = 0,
                    rows: int | None = None) -> torch.Tensor:
    """The "flow" mode's warp, `warp_blend_fast` (no overlap) of the JAX
    package: RGB of A block-warped by −t·flow and of B by (1 − t)·flow
    (K = `WARP_K`), mixed as va + (vb − va)·t; alpha cross-faded; rounded
    half to even. u8 [H, W, 4] × 2 + full-resolution flow → u8 (output rows
    row0 .. row0 + rows − 1, all by default)."""
    t = np.float32(time_t)
    rows = frame_a.shape[0] - row0 if rows is None else rows
    a4 = frame_a.to(torch.float32).permute(2, 0, 1)
    b4 = frame_b.to(torch.float32).permute(2, 0, 1)
    va = block_warp_planar(a4[:3], flow * float(-t), tile=tile, row0=row0, rows=rows)
    vb = block_warp_planar(b4[:3], flow * float(np.float32(1.0) - t), tile=tile, row0=row0, rows=rows)
    rgb = va + (vb - va) * float(t)
    a4, b4 = a4[:, row0 : row0 + rows], b4[:, row0 : row0 + rows]
    alpha = a4[3:] + (b4[3:] - a4[3:]) * float(t)
    out = torch.clamp(torch.round(torch.cat([rgb, alpha])), 0, 255).to(torch.uint8)
    return out.permute(1, 2, 0).contiguous()


# ---------------------------------------------------------------------------
# flow_soft
# ---------------------------------------------------------------------------


def soft_tiles_fit(h: int, w: int, tile: tuple) -> bool:
    """The shapes the soft warp kernel takes: the tile divides the frame, and
    the frame holds at least 2×2 tiles."""
    th, tw = tile
    return h % th == 0 and w % tw == 0 and h >= 2 * th and w >= 2 * tw


def _soft_warp_accumulate(acc, img_p: torch.Tensor, offset_field: torch.Tensor, k: int,
                          rng: int, tile: tuple, weight: float, row0: int = 0,
                          rows: int | None = None):
    """Add ``weight · soft_warp(img_p, offset_field)`` to the accumulator pair
    ``(acc_p, acc_q)`` (bf16 [C, H, W+1]; None starts it): the port's copy of
    `nu_scaler_tpu/ops/interpolate.py` _soft_warp_accumulate.

    Per candidate i of the tile field's top K: the frame shifted by the
    candidate (edge-clamped, on the (H+1)×(W+1) grid) as a bf16 slab, its
    rows lerped by the pixel's fraction clip(smooth motion − cand, 0, 1), and
    the pixel's weight on the candidate (the half-tile-shift bilinear mix of
    its four corner tiles' one-hot assignments) split between P and Q by the
    column fraction: out[j] = P[j] + Q[j + 1]. The bf16 casts are where the
    JAX function has them: they decide the last LSB. The accumulators hold
    output rows row0 .. row0 + rows − 1 (all by default): the fields are
    formed over the whole frame and cut to those rows, so each value is the
    whole frame's."""
    c, h, w = img_p.shape
    rows = h - row0 if rows is None else rows
    band = slice(row0, row0 + rows)
    th, tw = min(tile[0], h), min(tile[1], w)
    tiles = torch.clamp(_tile_mean(offset_field, th, tw), -rng, rng)
    cand_y, cand_x, assign = candidates(tiles, k, rng)
    dev = img_p.device
    w1 = w + 1  # the coefficient fields live on the slab's W + 1 grid
    img_bf = img_p.to(torch.bfloat16)
    slab_rows = torch.arange(row0, row0 + rows + 1, device=dev)
    slab_cols = torch.arange(w1, device=dev)

    def frac(n: int, size: int) -> torch.Tensor:
        f = ((np.arange(n, dtype=np.float64) + 0.5) / size - 0.5) % 1.0
        return torch.from_numpy(f.astype(np.float32)).to(dev)

    fyv, fxv = frac(h, th)[:, None], frac(w1, tw)[None, :]
    hh, hw = th // 2, tw // 2
    a_px = _tile_to_pixels(assign, th, tw, h, w1)
    a_t, a_b = _shift_edge(a_px, -hh, 0), _shift_edge(a_px, th - hh, 0)
    a_tl, a_tr = _shift_edge(a_t, -hw, 1), _shift_edge(a_t, tw - hw, 1)
    a_bl, a_br = _shift_edge(a_b, -hw, 1), _shift_edge(a_b, tw - hw, 1)

    def smooth(f: torch.Tensor) -> torch.Tensor:  # [Ty, Tx] → [H, W + 1]
        fp = _tile_to_pixels(f, th, tw, h, w1)
        fv = (1.0 - fyv) * _shift_edge(fp, -hh, 0) + fyv * _shift_edge(fp, th - hh, 0)
        return (1.0 - fxv) * _shift_edge(fv, -hw, 1) + fxv * _shift_edge(fv, tw - hw, 1)

    sx, sy = smooth(tiles[..., 0])[band], smooth(tiles[..., 1])[band]
    fyv = fyv[band]
    a_tl, a_tr, a_bl, a_br = (x[band] for x in (a_tl, a_tr, a_bl, a_br))
    if acc is None:
        acc = (torch.zeros((c, rows, w1), dtype=torch.bfloat16, device=dev),) * 2
    acc_p, acc_q = acc
    for i in range(k):
        src_rows = (slab_rows + cand_y[i]).clamp(0, h - 1)
        cols = (slab_cols + cand_x[i]).clamp(0, w - 1)
        s = img_bf[:, src_rows][:, :, cols]
        wv_t = torch.where(a_tl == i, 1.0 - fxv, 0.0) + torch.where(a_tr == i, fxv, 0.0)
        wv_b = torch.where(a_bl == i, 1.0 - fxv, 0.0) + torch.where(a_br == i, fxv, 0.0)
        wk_i = ((1.0 - fyv) * wv_t + fyv * wv_b) * weight
        fx = torch.clamp(sx - cand_x[i].to(torch.float32), 0.0, 1.0)
        fy = torch.clamp(sy - cand_y[i].to(torch.float32), 0.0, 1.0).to(torch.bfloat16)[None]
        row = s[:, :rows] + fy * (s[:, 1:] - s[:, :rows])
        acc_p = acc_p + (wk_i * (1.0 - fx)).to(torch.bfloat16)[None] * row
        acc_q = acc_q + (wk_i * fx).to(torch.bfloat16)[None] * row
    return acc_p, acc_q


def warp_blend_soft(frame_a: torch.Tensor, frame_b: torch.Tensor, flow: torch.Tensor,
                    time_t: float, tile: tuple = WARP_TILE, row0: int = 0,
                    rows: int | None = None) -> torch.Tensor:
    """The ragged branch's warp, `warp_blend_fast(overlap=True)` of the JAX
    package without its Pallas kernel: A warped by −t·flow at weight 1 − t
    and B by (1 − t)·flow at weight t into one accumulator pair (K =
    `WARP_K`), alpha cross-faded, rounded half to even. u8 [H, W, 4] × 2 +
    full-resolution flow → u8 (output rows row0 .. row0 + rows − 1, all by
    default)."""
    t = np.float32(time_t)
    one_minus_t = np.float32(1.0) - t
    rows = frame_a.shape[0] - row0 if rows is None else rows
    a4 = frame_a.to(torch.float32).permute(2, 0, 1)
    b4 = frame_b.to(torch.float32).permute(2, 0, 1)
    w = frame_a.shape[1]
    acc = _soft_warp_accumulate(None, a4[:3], flow * float(-t), WARP_K, WARP_RANGE, tile,
                                float(one_minus_t), row0, rows)
    acc = _soft_warp_accumulate(acc, b4[:3], flow * float(one_minus_t), WARP_K, WARP_RANGE, tile,
                                float(t), row0, rows)
    rgb = (acc[0][:, :, :w] + acc[1][:, :, 1:]).to(torch.float32)
    a4, b4 = a4[:, row0 : row0 + rows], b4[:, row0 : row0 + rows]
    alpha = a4[3:] + (b4[3:] - a4[3:]) * float(t)
    out = torch.clamp(torch.round(torch.cat([rgb, alpha])), 0, 255).to(torch.uint8)
    return out.permute(1, 2, 0).contiguous()


def soft_front_end(flow: torch.Tensor, time_t: float, tile: tuple = WARP_TILE):
    """The soft warp kernel's front end for a full-resolution flow: both
    frames' `FrameInputs` from the flow's tile means (clipped, top-K
    candidates, assignments; K = `WARP_K`, the JAX kernel's default), on the
    flow's device."""
    return frame_inputs(_tile_mean(flow, *tile), time_t, WARP_K, WARP_RANGE)


def warp_blend_overlap(frame_a: torch.Tensor, frame_b: torch.Tensor, flow: torch.Tensor,
                       time_t: float, tile: tuple = WARP_TILE) -> torch.Tensor:
    """`warp_blend_fast(overlap=True)` of the JAX package
    (`nu_scaler_tpu/ops/interpolate.py:644-690`) on a full-resolution flow:
    the soft warp kernel on the flow's tile means (K = `WARP_K`) where the
    tile fits the frame (`soft_tiles_fit`), else `warp_blend_soft`. The
    flow-given warp of the mesh functions (`parallel/mesh.py`)."""
    h, w = frame_a.shape[0], frame_a.shape[1]
    if frame_a.shape[-1] == 4 and soft_tiles_fit(h, w, tile):
        return soft_warp_blend(frame_a, frame_b, _tile_mean(flow, *tile), time_t, tile=tile,
                               rng=WARP_RANGE, k=WARP_K)
    return warp_blend_soft(frame_a, frame_b, flow, time_t, tile)


def _check_rgba(frame: torch.Tensor) -> None:
    if frame.dim() != 3 or frame.shape[-1] != 4:
        raise ValueError(f"flow_soft takes RGBA frames [H, W, 4], got {tuple(frame.shape)}")


def soft_interp_fast(
    frame_a: torch.Tensor, frame_b: torch.Tensor, time_t: float, tile: tuple = WARP_TILE,
    k: int = SOFT_WARP_K,
) -> torch.Tensor:
    """The production "flow_soft" step: u8 [H, W, 4] × 2 → u8 [H, W, 4]:
    tile motion (`flow_tiles_fast`), then one soft warp launch; a ragged
    frame takes full-resolution flow and `warp_blend_soft`."""
    _check_rgba(frame_a)
    h, w = frame_a.shape[0], frame_a.shape[1]
    if not soft_tiles_fit(h, w, tile):
        flow = compute_flow_fast(frame_a, frame_b, base_level=0)
        return warp_blend_soft(frame_a, frame_b, flow, time_t, tile)
    tiles = flow_tiles_fast(frame_a, frame_b, tile)
    return soft_warp_blend(frame_a, frame_b, tiles, time_t, tile=tile, rng=WARP_RANGE, k=k)


def soft_interp_multi(
    frame_a: torch.Tensor, frame_b: torch.Tensor, ts: Sequence[float], tile: tuple = WARP_TILE,
    k: int = SOFT_WARP_K,
) -> torch.Tensor:
    """N-factor frame generation: one motion solve, one soft warp per time
    → u8 [len(ts), H, W, 4]."""
    _check_rgba(frame_a)
    h, w = frame_a.shape[0], frame_a.shape[1]
    if not soft_tiles_fit(h, w, tile):
        flow = compute_flow_fast(frame_a, frame_b, base_level=0)
        return torch.stack([warp_blend_soft(frame_a, frame_b, flow, t, tile) for t in ts])
    tiles = flow_tiles_fast(frame_a, frame_b, tile)
    return torch.stack([
        soft_warp_blend(frame_a, frame_b, tiles, t, tile=tile, rng=WARP_RANGE, k=k) for t in ts
    ])


# ---------------------------------------------------------------------------
# flow_soft_ref
# ---------------------------------------------------------------------------

# The JAX package's serving floor of the refinement net (its
# `REFINE_MIN_ROWS`, 0 for the adopted checkpoints: the net gains at every
# measured height); below it the production modes serve plain flow_soft.
REFINE_MIN_ROWS = 0


def refine_serves(height: int, width: int) -> bool:
    """True when the learned refinement serves at this frame size: both
    sides multiples of the net's stride (4) and the height at least
    `REFINE_MIN_ROWS` (`nu_scaler_tpu/ops/interpolate.py:945-950`)."""
    st = interp_refine.STRIDE
    return height % st == 0 and width % st == 0 and height >= REFINE_MIN_ROWS


def _refine_graph(height: int, width: int, dev: torch.device):
    """The refinement graph at this size, or None where it does not serve.
    Missing or corrupt weights raise."""
    return interp_refine.get_refine_graph(height, width, dev) if refine_serves(height, width) else None


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------


def _check_frames(height: int, width: int, *frames) -> None:
    for x in frames:
        if tuple(x.shape) != (height, width, 4):
            raise ValueError(f"expected [{height}, {width}, 4], got {tuple(x.shape)}")


@functools.lru_cache(maxsize=64)
def _interpolator(height: int, width: int, mode: str, dev: torch.device, warp_tile: tuple):
    check_mode(mode)
    if mode == "blend":
        def step(a, b, t):
            return blend_only(a, b, t)
    elif mode == "flow_soft":
        def step(a, b, t):
            return soft_interp_fast(a, b, t, tile=warp_tile)
    elif mode == "flow_soft_ref":
        ref = _refine_graph(height, width, dev)

        def step(a, b, t):
            mid = soft_interp_fast(a, b, t, tile=warp_tile)
            return mid if ref is None else ref(a, b, mid)
    elif mode == "flow":
        def step(a, b, t):
            return warp_blend_fast(a, b, compute_flow_fast(a, b), t, tile=warp_tile)
    elif mode == "flow_exact":
        def step(a, b, t):
            return warp_blend(a, b, compute_flow(a, b), t)
    else:
        raise ValueError(f"unknown interpolation mode: {mode!r}")

    def fn(a, b, t):
        _check_frames(height, width, a, b)
        return step(a.to(dev), b.to(dev), t)

    return fn


def make_interpolator(
    height: int, width: int, mode: str = "blend", device=None, warp_tile: tuple = WARP_TILE
):
    """``(frame_a, frame_b, t) -> mid`` u8 tensors on `device` (the card
    unless "cpu"), for a fixed size. Modes "blend", "flow_soft",
    "flow_soft_ref" (the flow_soft mid refined by the learned net where
    `refine_serves`), "flow" (`compute_flow_fast` at 8 residual iterations,
    then `warp_blend_fast`) and "flow_exact" (`compute_flow` at
    `DEFAULT_REFINE_ITERS`, then `warp_blend`); `warp_tile` is the warp tile
    of the flow_soft modes and flow (the workgroup-preset knob)."""
    return _interpolator(height, width, mode, resolve_device(device), tuple(warp_tile))


@functools.lru_cache(maxsize=64)
def _multi_interpolator(height: int, width: int, ts: tuple, mode: str, dev, warp_tile: tuple):
    check_mode(mode)
    if mode == "blend":
        def step(a, b):
            return torch.stack([blend_only(a, b, t) for t in ts])
    elif mode == "flow_soft":
        def step(a, b):
            return soft_interp_multi(a, b, ts, tile=warp_tile)
    elif mode == "flow_soft_ref":
        ref = _refine_graph(height, width, dev)

        def step(a, b):
            mids = soft_interp_multi(a, b, ts, tile=warp_tile)
            return mids if ref is None else torch.stack([ref(a, b, m) for m in mids])
    elif mode == "flow":
        def step(a, b):
            flow = compute_flow_fast(a, b)
            return torch.stack([warp_blend_fast(a, b, flow, t, tile=warp_tile) for t in ts])
    else:
        raise ValueError(f"unknown multi-interpolation mode: {mode!r}")

    def fn(a, b):
        _check_frames(height, width, a, b)
        return step(a.to(dev), b.to(dev))

    return fn


def make_multi_interpolator(
    height: int, width: int, ts: Sequence[float], mode: str = "flow_soft", device=None,
    warp_tile: tuple = WARP_TILE,
):
    """``(frame_a, frame_b) -> [len(ts), H, W, 4]``: one motion solve per
    pair shared by every time (flow_soft, flow_soft_ref, flow), or one
    cross-fade per time (blend). "flow_exact" has no multi-time form, as in
    the JAX package."""
    ts = tuple(float(t) for t in ts)
    return _multi_interpolator(height, width, ts, mode, resolve_device(device), tuple(warp_tile))


class RefinedUpscaler:
    """flow_soft → the learned refinement → the resample, in one call
    (`make_refined_mid_upscaler`, `make_refined_multi_upscaler`): u8 frames
    a, b [H, W, 4] → the refined mid at each time, resampled to
    [OH, OW, 4]: the u8 mid, refined where the refinement serves, through
    `make_resampler`."""

    def __init__(self, in_h: int, in_w: int, out_h: int, out_w: int, algorithm: str,
                 warp_tile: tuple, dev: torch.device) -> None:
        self.in_hw, self.warp_tile, self.device = (in_h, in_w), tuple(warp_tile), dev
        self.ref = _refine_graph(in_h, in_w, dev)
        self.up = make_resampler(in_h, in_w, out_h, out_w, algorithm, dev)

    def frames(self, a, b) -> tuple[torch.Tensor, torch.Tensor]:
        a, b = to_device_u8(a, self.device), to_device_u8(b, self.device)
        _check_frames(*self.in_hw, a, b)
        return a, b

    def refine_up(self, a: torch.Tensor, b: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
        """One mid of the pair (a, b), refined and resampled."""
        return self.up(mid if self.ref is None else self.ref(a, b, mid))


class RefinedMidUpscaler(RefinedUpscaler):
    def __call__(self, a, b, t: float) -> torch.Tensor:
        a, b = self.frames(a, b)
        return self.refine_up(a, b, soft_interp_fast(a, b, t, tile=self.warp_tile))


class RefinedMultiUpscaler(RefinedUpscaler):
    def __init__(self, in_h: int, in_w: int, out_h: int, out_w: int, ts: tuple, algorithm: str,
                 warp_tile: tuple, dev: torch.device) -> None:
        super().__init__(in_h, in_w, out_h, out_w, algorithm, warp_tile, dev)
        self.ts = ts

    def __call__(self, a, b) -> torch.Tensor:
        a, b = self.frames(a, b)
        mids = soft_interp_multi(a, b, self.ts, tile=self.warp_tile)
        return torch.stack([self.refine_up(a, b, m) for m in mids])


@functools.lru_cache(maxsize=16)
def _refined_mid_upscaler(in_h, in_w, out_h, out_w, algorithm, warp_tile, dev) -> RefinedMidUpscaler:
    return RefinedMidUpscaler(in_h, in_w, out_h, out_w, algorithm, warp_tile, dev)


def make_refined_mid_upscaler(in_h: int, in_w: int, out_h: int, out_w: int, algorithm: str = "lanczos3",
                              warp_tile: tuple = WARP_TILE, device=None) -> RefinedMidUpscaler:
    """``(a_u8, b_u8, t) -> u8 [out_h, out_w, 4]`` on `device` (the card
    unless "cpu"): the soft warp, the learned refinement and the resample
    (`nu_scaler_tpu/ops/interpolate.py:1018-1063`); cached."""
    return _refined_mid_upscaler(in_h, in_w, out_h, out_w, algorithm, tuple(warp_tile), resolve_device(device))


@functools.lru_cache(maxsize=16)
def _refined_multi_upscaler(in_h, in_w, out_h, out_w, ts, algorithm, warp_tile, dev) -> RefinedMultiUpscaler:
    return RefinedMultiUpscaler(in_h, in_w, out_h, out_w, ts, algorithm, warp_tile, dev)


def make_refined_multi_upscaler(in_h: int, in_w: int, out_h: int, out_w: int, ts: Sequence[float],
                                algorithm: str = "lanczos3", warp_tile: tuple = WARP_TILE,
                                device=None) -> RefinedMultiUpscaler:
    """``(a_u8, b_u8) -> u8 [len(ts), out_h, out_w, 4]``: one motion solve
    per pair, each mid refined and resampled
    (`nu_scaler_tpu/ops/interpolate.py:1066-1118`); cached."""
    ts = tuple(float(t) for t in ts)
    return _refined_multi_upscaler(in_h, in_w, out_h, out_w, ts, algorithm, tuple(warp_tile),
                                   resolve_device(device))


def interpolate_frames(frame_a, frame_b, time_t: float = 0.5, mode: str = "blend",
                       device=None) -> torch.Tensor:
    """One mid frame of u8 [H, W, 4] numpy or torch frames in `mode`, as a u8
    tensor on `device` (the card unless "cpu")."""
    dev = resolve_device(device)
    a, b = to_device_u8(frame_a, dev), to_device_u8(frame_b, dev)
    return make_interpolator(a.shape[-3], a.shape[-2], mode, dev)(a, b, float(time_t))


# ---------------------------------------------------------------------------
# device time of a step and of its stages (the reference's timestamp queries)
# ---------------------------------------------------------------------------
#
# A calibration per (shape, mode, device), cached as the reference resolved
# its query set once per pass layout: `iters` chained steps on seeded noise,
# each step fed the last one's output, timed by `utils.tracing.device_timer`.


def _mk_frames(height: int, width: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 256, (height, width, 4), np.uint8)).to(device)
    b = torch.from_numpy(rng.integers(0, 256, (height, width, 4), np.uint8)).to(device)
    return a, b


@functools.lru_cache(maxsize=64)
def _calibrated_step_ms(height: int, width: int, mode: str, warp_tile: tuple, iters: int,
                        dev: torch.device) -> float:
    fn = make_interpolator(height, width, mode, dev, warp_tile)
    a, b = _mk_frames(height, width, dev)
    return device_timer(lambda s: (s[1], fn(s[0], s[1], 0.5)), (a, b), iters=iters) * 1000.0


def calibrated_step_ms(height: int, width: int, mode: str = "blend", warp_tile: tuple = WARP_TILE,
                       iters: int = 20, device=None) -> float:
    """Device ms of one full interpolation step at this shape and mode on
    `device` (the card unless "cpu"); cached."""
    return _calibrated_step_ms(height, width, mode, tuple(warp_tile), iters, resolve_device(device))


@functools.lru_cache(maxsize=64)
def _stage_timings_ms(height: int, width: int, mode: str, warp_tile: tuple, iters: int,
                      dev: torch.device) -> dict:
    total = _calibrated_step_ms(height, width, mode, warp_tile, iters, dev)
    if mode == "blend":
        return {"total_ms": total, "blend_ms": total}
    a, b = _mk_frames(height, width, dev)
    fast = mode in ("flow", "flow_soft", "flow_soft_ref")
    soft = mode in ("flow_soft", "flow_soft_ref")
    soft_kernel = soft and soft_tiles_fit(height, width, warp_tile)

    # the flow stage: the next input is perturbed by the flow, so that each
    # step depends on the last
    def flow_body(s):
        fa, fb = s
        if soft_kernel:
            tiles = flow_tiles_fast(fa, fb, warp_tile)
            pert = (tiles[0, 0, 0] * 8.0).to(torch.int32).to(torch.uint8)
        else:
            flow = compute_flow_fast(fa, fb) if fast else compute_flow(fa, fb)
            pert = (flow[..., :1] * 8.0).to(torch.int32).to(torch.uint8)
        return fb, fb + pert

    flow_ms = device_timer(flow_body, (a, b), iters=iters) * 1000.0

    if soft_kernel:
        ty, tx = height // warp_tile[0], width // warp_tile[1]
        tiles0 = torch.full((ty, tx, 2), 1.3, dtype=torch.float32, device=dev)

        def soft_body(s):
            fa, fb, tl = s
            out = soft_warp_blend(fa, fb, tl, 0.5, tile=warp_tile, rng=WARP_RANGE, k=SOFT_WARP_K)
            return fb, out, tl * 0.5 + out[:ty, :tx, :2].to(torch.float32) * 1e-6

        warp_ms = device_timer(soft_body, (a, b, tiles0), iters=iters) * 1000.0
        out = {"total_ms": total, "flow_ms": flow_ms, "warp_ms": warp_ms}
        if mode == "flow_soft_ref":
            # the refinement rides the same step: its share is the step's
            # total less the flow and warp stages, floored at 0
            out["refine_ms"] = max(total - flow_ms - warp_ms, 0.0)
        return out

    if soft:
        def warp_fn(fa, fb, fl, t):
            return warp_blend_soft(fa, fb, fl, t, tile=warp_tile)
    elif fast:
        def warp_fn(fa, fb, fl, t):
            return warp_blend_fast(fa, fb, fl, t, tile=warp_tile)
    else:
        warp_fn = warp_blend
    flow0 = torch.zeros((height, width, 2), dtype=torch.float32, device=dev)

    def warp_body(s):
        fa, fb, fl = s
        out = warp_fn(fa, fb, fl, 0.5)
        return fb, out, fl * 0.5 + out[..., :2].to(torch.float32) * 1e-6

    warp_ms = device_timer(warp_body, (a, b, flow0), iters=iters) * 1000.0
    return {"total_ms": total, "flow_ms": flow_ms, "warp_ms": warp_ms}


def stage_timings_ms(height: int, width: int, mode: str = "blend", warp_tile: tuple = WARP_TILE,
                     iters: int = 20, device=None) -> dict:
    """Per-stage device ms on `device` (the card unless "cpu"), with the JAX
    function's keys: "blend" {total_ms, blend_ms}; the flow modes {total_ms,
    flow_ms, warp_ms}, the stages timed apart (flow_soft's warp stage is the
    soft warp kernel's wrapper, its front end included); "flow_soft_ref" on
    a frame the warp tile divides also refine_ms, the total less flow and
    warp, floored at 0. Cached; do not mutate the dict."""
    return _stage_timings_ms(height, width, mode, tuple(warp_tile), iters, resolve_device(device))
