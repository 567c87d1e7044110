"""Frame interpolation ops of the port: the counterpart of
`nu_scaler_tpu/ops/interpolate.py` for the zero-flow cross-fade ("blend") and
the production motion-compensated mode ("flow_soft").

flow_soft, per frame pair (u8 [H, W, 4] × 2):

    luma pyramid (4 levels)  →  Horn–Schunck (HS) at the coarsest level
    →  one refinement level per step up to `base_level` (block warp of B by
    the upsampled flow + HS on the residual)  →  per-tile mean motion
    →  the overlapped-tile soft warp kernel (`kernels/soft_warp_cuda.py`).

A frame that the warp tile does not divide (or that holds fewer than 2×2
tiles) takes the JAX package's ragged branch instead: full-resolution flow,
then the overlapped soft warp of `warp_blend_soft` in plain PyTorch, with the
JAX function's bf16 slabs and accumulators.

The flow stage was plain XLA in the JAX package and is plain PyTorch here:
elementwise ops, gathers and small sums, all fp32 and none a matmul or a
convolution, so the caller's TF32 settings cannot reach it. The soft warp is
the one CUDA kernel of the mode. The other flow modes ("flow", "flow_exact")
are ROADMAP queue 1, item 8; "flow_soft_ref" is item 10. They raise
NotImplementedError.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.kernels.soft_warp_cuda import candidates, soft_warp_blend
from nu_scaler_tpu_torch.ops.resample import apply_taps, device_taps, resize_f32

MODES = ("blend", "flow", "flow_soft", "flow_soft_ref", "flow_exact")
PORTED_MODES = ("blend", "flow_soft")
_NOT_PORTED = {
    "flow": "ROADMAP queue 1, item 8",
    "flow_exact": "ROADMAP queue 1, item 8",
    "flow_soft_ref": "ROADMAP queue 1, item 10",
}

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


def _not_ported(mode: str) -> NotImplementedError:
    return NotImplementedError(f"interpolation mode {mode!r} is not ported yet ({_NOT_PORTED[mode]})")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown interpolation mode: {mode!r}")
    if mode not in PORTED_MODES:
        raise _not_ported(mode)


# ---------------------------------------------------------------------------
# luma pyramid
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


def horn_schunck(lum1: torch.Tensor, lum2: torch.Tensor, flow0: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` Jacobi iterations of the coarse HS update (λ =
    `DEFAULT_LAMBDA`); flow [h, w, 2] (x, y) in and out. Gradients and It are hoisted out of the loop; the loop
    runs on the planar [2, h, w] flow."""
    ix, iy = _gradients(lum1)
    it = lum2 - lum1
    denom = DEFAULT_LAMBDA + ix * ix + iy * iy
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
    tile: tuple = WARP_TILE,
) -> torch.Tensor:
    """Sample planar `img_p` [C, H, W] f32 at p + offset(p), block-quantized:
    the top-K integer offsets of the tile means, each tile's nearest one, one
    gather of the candidate-shifted image and one bilinear lerp with the
    tile's fractions. As in the JAX function, the lerp reads the +1
    neighbour under the pixel's own tile's offset even across a tile border
    (the 1-px "lerp after select" approximation)."""
    c, h, w = img_p.shape
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
    fry_px = _tile_to_pixels(fry, th, tw, h, w)
    frx_px = _tile_to_pixels(frx, th, tw, h, w)
    # the candidate-shifted image on the (h+1)×(w+1) grid, edge-clamped
    assign_pad = _tile_to_pixels(assign, th, tw, h + 1, w + 1)
    rows = (torch.arange(h + 1, device=img_p.device)[:, None] + cand_y[assign_pad]).clamp(0, h - 1)
    cols = (torch.arange(w + 1, device=img_p.device)[None, :] + cand_x[assign_pad]).clamp(0, w - 1)
    combined = img_p[:, rows, cols]
    top_row = combined[:, :h, :w] + frx_px * (combined[:, :h, 1:] - combined[:, :h, :w])
    bot_row = combined[:, 1:, :w] + frx_px * (combined[:, 1:, 1:] - combined[:, 1:, :w])
    return top_row + fry_px * (bot_row - top_row)


# ---------------------------------------------------------------------------
# flow
# ---------------------------------------------------------------------------


def compute_flow_fast(frame_a: torch.Tensor, frame_b: torch.Tensor, base_level: int) -> torch.Tensor:
    """Coarse-to-fine flow (x, y) A→B at pyramid level `base_level`, in that
    level's pixel units: HS at the coarsest level, then per finer level down
    to `base_level`, B block-warped toward A by the upsampled flow and HS on
    the residual (8 iterations)."""
    lums_a = build_luma_pyramid(frame_a, DEFAULT_PYRAMID_LEVELS)
    lums_b = build_luma_pyramid(frame_b, DEFAULT_PYRAMID_LEVELS)
    levels = len(lums_a)  # tiny frames: the pyramid stops before degenerating
    base_level = min(base_level, levels - 1)

    flow = torch.zeros(*lums_a[-1].shape, 2, dtype=torch.float32, device=frame_a.device)
    flow = horn_schunck(lums_a[-1], lums_b[-1], flow, DEFAULT_COARSE_ITERS)
    for lvl in range(levels - 2, base_level - 1, -1):
        th, tw = lums_a[lvl].shape[-2], lums_a[lvl].shape[-1]
        flow = flow_upsample(flow, th, tw) * 2.0
        b_warp = block_warp_planar(lums_b[lvl][None], flow)[0]
        flow = flow + horn_schunck(lums_a[lvl], b_warp, torch.zeros_like(flow), 8)
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
    return _tile_mean(compute_flow_fast(frame_a, frame_b, base_level), th // s, tw // s) * float(s)


# ---------------------------------------------------------------------------
# flow_soft
# ---------------------------------------------------------------------------


def soft_tiles_fit(h: int, w: int, tile: tuple) -> bool:
    """The shapes the soft warp kernel takes: the tile divides the frame, and
    the frame holds at least 2×2 tiles."""
    th, tw = tile
    return h % th == 0 and w % tw == 0 and h >= 2 * th and w >= 2 * tw


def _soft_warp_accumulate(acc, img_p: torch.Tensor, offset_field: torch.Tensor, k: int,
                          rng: int, tile: tuple, weight: float):
    """Add ``weight · soft_warp(img_p, offset_field)`` to the accumulator pair
    ``(acc_p, acc_q)`` (bf16 [C, H, W+1]; None starts it): the port's copy of
    `nu_scaler_tpu/ops/interpolate.py` _soft_warp_accumulate.

    Per candidate i of the tile field's top K: the frame shifted by the
    candidate (edge-clamped, on the (H+1)×(W+1) grid) as a bf16 slab, its
    rows lerped by the pixel's fraction clip(smooth motion − cand, 0, 1), and
    the pixel's weight on the candidate (the half-tile-shift bilinear mix of
    its four corner tiles' one-hot assignments) split between P and Q by the
    column fraction: out[j] = P[j] + Q[j + 1]. The bf16 casts are where the
    JAX function has them: they decide the last LSB."""
    c, h, w = img_p.shape
    th, tw = min(tile[0], h), min(tile[1], w)
    tiles = torch.clamp(_tile_mean(offset_field, th, tw), -rng, rng)
    cand_y, cand_x, assign = candidates(tiles, k, rng)
    dev = img_p.device
    w1 = w + 1  # the coefficient fields live on the slab's W + 1 grid
    img_bf = img_p.to(torch.bfloat16)
    slab_rows = torch.arange(h + 1, device=dev)
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

    sx, sy = smooth(tiles[..., 0]), smooth(tiles[..., 1])
    if acc is None:
        acc = (torch.zeros((c, h, w1), dtype=torch.bfloat16, device=dev),) * 2
    acc_p, acc_q = acc
    for i in range(k):
        rows = (slab_rows + cand_y[i]).clamp(0, h - 1)
        cols = (slab_cols + cand_x[i]).clamp(0, w - 1)
        s = img_bf[:, rows][:, :, cols]
        wv_t = torch.where(a_tl == i, 1.0 - fxv, 0.0) + torch.where(a_tr == i, fxv, 0.0)
        wv_b = torch.where(a_bl == i, 1.0 - fxv, 0.0) + torch.where(a_br == i, fxv, 0.0)
        wk_i = ((1.0 - fyv) * wv_t + fyv * wv_b) * weight
        fx = torch.clamp(sx - cand_x[i].to(torch.float32), 0.0, 1.0)
        fy = torch.clamp(sy - cand_y[i].to(torch.float32), 0.0, 1.0).to(torch.bfloat16)[None]
        row = s[:, :h] + fy * (s[:, 1:] - s[:, :h])
        acc_p = acc_p + (wk_i * (1.0 - fx)).to(torch.bfloat16)[None] * row
        acc_q = acc_q + (wk_i * fx).to(torch.bfloat16)[None] * row
    return acc_p, acc_q


def warp_blend_soft(frame_a: torch.Tensor, frame_b: torch.Tensor, flow: torch.Tensor,
                    time_t: float, tile: tuple = WARP_TILE) -> torch.Tensor:
    """The ragged branch's warp, `warp_blend_fast(overlap=True)` of the JAX
    package: A warped by −t·flow at weight 1 − t and B by (1 − t)·flow at
    weight t into one accumulator pair (K = `WARP_K`), alpha cross-faded,
    rounded half to even. u8 [H, W, 4] × 2 + full-resolution flow → u8."""
    t = np.float32(time_t)
    one_minus_t = np.float32(1.0) - t
    a4 = frame_a.to(torch.float32).permute(2, 0, 1)
    b4 = frame_b.to(torch.float32).permute(2, 0, 1)
    w = frame_a.shape[1]
    acc = _soft_warp_accumulate(None, a4[:3], flow * float(-t), WARP_K, WARP_RANGE, tile,
                                float(one_minus_t))
    acc = _soft_warp_accumulate(acc, b4[:3], flow * float(one_minus_t), WARP_K, WARP_RANGE, tile,
                                float(t))
    rgb = (acc[0][:, :, :w] + acc[1][:, :, 1:]).to(torch.float32)
    alpha = a4[3:] + (b4[3:] - a4[3:]) * float(t)
    out = torch.clamp(torch.round(torch.cat([rgb, alpha])), 0, 255).to(torch.uint8)
    return out.permute(1, 2, 0).contiguous()


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
    else:
        raise _not_ported(mode)

    def fn(a, b, t):
        _check_frames(height, width, a, b)
        return step(a.to(dev), b.to(dev), t)

    return fn


def make_interpolator(
    height: int, width: int, mode: str = "blend", device=None, warp_tile: tuple = WARP_TILE
):
    """``(frame_a, frame_b, t) -> mid`` u8 tensors on `device` (the card
    unless "cpu"), for a fixed size. Modes "blend" and "flow_soft";
    `warp_tile` is flow_soft's warp tile (the workgroup-preset knob)."""
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
    else:
        raise _not_ported(mode)

    def fn(a, b):
        _check_frames(height, width, a, b)
        return step(a.to(dev), b.to(dev))

    return fn


def make_multi_interpolator(
    height: int, width: int, ts: Sequence[float], mode: str = "flow_soft", device=None,
    warp_tile: tuple = WARP_TILE,
):
    """``(frame_a, frame_b) -> [len(ts), H, W, 4]``: one motion solve per
    pair shared by every time (flow_soft), or one cross-fade per time
    (blend)."""
    ts = tuple(float(t) for t in ts)
    return _multi_interpolator(height, width, ts, mode, resolve_device(device), tuple(warp_tile))
