"""Wrapper of the overlapped-tile soft-warp kernel (`csrc/soft_warp.cu`), its
front end (candidate selection) and its plain PyTorch version.

`soft_warp_blend` replaces `nu_scaler_tpu/kernels/soft_warp_pallas.py:984`
(soft_warp_blend → `_build` → `_kernel_strip_v7`): the motion-compensated
blend of two u8 ``[H, W, 4]`` frames given the per-tile mean motion
``[H/th, W/tw, 2]`` (x, y) of the step A→B. `soft_warp_rows` is the same
kernel on a band of output rows, given the whole frame's front end
(`frame_inputs`): the sp mesh path (`parallel/mesh.py`) solves the front end
once and gives each shard its rows, with the bytes of the whole frame's
launch.

Per frame f — A warped by ``−t·motion`` with weight ``1 − t``, B by
``(1 − t)·motion`` with weight ``t`` — the front end clips the scaled tile
motion to ``±rng``, picks the K most common integer offsets (`hist_topk`) and
gives every tile its nearest candidate (`candidates`). Output pixel (r, c)
then lies in a cell of the half-tile-offset grid; it mixes its cell's four
corner tiles bilinearly, and each corner samples the frame bilinearly at
``(r, c) + cand[assign[corner]]`` with the subpixel fraction
``clip(smooth motion − cand, 0, 1)``. The sum is rounded half to even.

Both the kernel and the plain version take the same inputs (the clipped
tiles, the assignments and the candidates computed here on the tensor's
device, with no host sync) and do the same fp32 operations in the same order,
each rounded on its own (the kernel uses `__fadd_rn` / `__fmul_rn`, so nvcc
forms no FMA). A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Launches since the last `reset_launches()`; the wrapper adds one where it
# launches its kernel and nowhere else.
launches = {"soft_warp_blend": 0}

MAX_K = 8
# The kernel finds a group's cell column as (c + tw/2) / tw from the f32
# reciprocal of tw with one correction step each way, exact below 2^23; and
# it runs one block row per cell row, at most 65535 of them.
MAX_WIDTH = 1 << 22
MAX_CELL_ROWS = 65535


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# front end: candidates (the port's copy of soft_warp_pallas.py:67-109)
# ---------------------------------------------------------------------------


def hist_topk(q: torch.Tensor, side: int, k: int) -> torch.Tensor:
    """Top-K bins of the 2-D histogram of the integer offsets `q` ([..., 2]
    as (x, y), already shifted to bins 0..side-1), flat bin = y·side + x.
    Order: descending count, ties by ascending bin (what `lax.top_k` and the
    JAX chain of first-index argmaxes give). The counts are exact integers
    (scatter-add); the stable sort keeps the tie order."""
    ids = (q[..., 1] * side + q[..., 0]).reshape(-1).to(torch.int64)
    hist = torch.zeros(side * side, dtype=torch.int64, device=q.device)
    hist.scatter_add_(0, ids, torch.ones_like(ids))
    return torch.sort(hist, descending=True, stable=True).indices[:k]


def candidates(tiles: torch.Tensor, k: int, rng: int):
    """Global top-K integer offsets of the tile field [Ty, Tx, 2] (x, y) and
    each tile's nearest one: (cand_y [K], cand_x [K], assign [Ty, Tx]), all
    int64. `argmin` takes the first of equally near candidates."""
    q = torch.floor(tiles).to(torch.int64)
    side = 2 * rng + 2
    top = hist_topk(q + rng, side, k)
    cand_y = top // side - rng
    cand_x = top % side - rng
    d2 = (q[..., 1, None] - cand_y) ** 2 + (q[..., 0, None] - cand_x) ** 2
    return cand_y, cand_x, torch.argmin(d2, dim=-1)


class FrameInputs(NamedTuple):
    """One frame's share of the warp: clipped tile motion [Ty, Tx, 2] (x, y),
    assignments [Ty, Tx], candidates [K], and the frame's blend weight."""

    tiles: torch.Tensor
    assign: torch.Tensor
    cand_y: torch.Tensor
    cand_x: torch.Tensor
    weight: float


def frame_inputs(tiles: torch.Tensor, t: float, k: int, rng: int) -> tuple[FrameInputs, FrameInputs]:
    """Both frames' inputs, in the fp32 op order of `soft_warp_pallas.py:
    904-957`: sign_A = −t, sign_B = 1 − t, tiles_f = clip(sign·tiles, ±rng);
    weights 1 − t and t."""
    tf = np.float32(t)
    out = []
    for sign, weight in ((-tf, np.float32(1.0) - tf), (np.float32(1.0) - tf, tf)):
        tiles_f = torch.clamp(tiles * float(sign), -rng, rng)
        cand_y, cand_x, assign = candidates(tiles_f, k, rng)
        out.append(FrameInputs(tiles_f, assign, cand_y, cand_x, float(weight)))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _cell_axis(n: int, tile: int, n_tiles: int, device, start: int = 0):
    """Per output row (or column) start .. n − 1: its two corner tiles on the
    half-tile-offset cell grid, edge-clamped, and the bilinear fraction
    (local + 0.5)·(1/tile)."""
    p = torch.arange(start, n, device=device)
    cell = (p + tile // 2) // tile
    local = p + tile // 2 - cell * tile
    t0 = (cell - 1).clamp(0, n_tiles - 1)
    t1 = cell.clamp(0, n_tiles - 1)
    frac = (local.to(torch.float32) + 0.5) * float(np.float32(1.0 / tile))
    return t0, t1, frac


def corner_assign(frames, h: int, w: int, tile: tuple) -> list[torch.Tensor]:
    """Per frame, the candidate index of each pixel's four cell corners,
    [4, H, W] (top-left, top-right, bottom-left, bottom-right)."""
    th, tw = tile
    ty, tx = h // th, w // tw
    dev = frames[0].assign.device
    y0, y1, _ = _cell_axis(h, th, ty, dev)
    x0, x1, _ = _cell_axis(w, tw, tx, dev)
    out = []
    for fr in frames:
        a = fr.assign
        out.append(torch.stack([a[y0][:, x0], a[y0][:, x1], a[y1][:, x0], a[y1][:, x1]]))
    return out


def soft_warp_plain(a: torch.Tensor, b: torch.Tensor, frames, tile: tuple, row0: int = 0,
                    rows: int | None = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops, vectorised over pixels: output
    rows row0 .. row0 + rows − 1 (the whole frame by default)."""
    h, w = a.shape[0], a.shape[1]
    rows = h - row0 if rows is None else rows
    th, tw = tile
    ty, tx = h // th, w // tw
    dev = a.device
    y0, y1, fy = _cell_axis(row0 + rows, th, ty, dev, row0)
    x0, x1, fx = _cell_axis(w, tw, tx, dev)
    gy, gx = (1.0 - fy)[:, None], (1.0 - fx)[None, :]
    fy, fx = fy[:, None], fx[None, :]
    bw = (gy * gx, gy * fx, fy * gx, fy * fx)
    corners = ((y0, x0), (y0, x1), (y1, x0), (y1, x1))
    out_rows = torch.arange(row0, row0 + rows, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    acc = None
    for img, fr in zip((a, b), frames):
        kks = [fr.assign[ry][:, rx] for ry, rx in corners]
        src = img.to(torch.float32)
        sy = [fr.tiles[..., 1][ry][:, rx] for ry, rx in corners]
        sx = [fr.tiles[..., 0][ry][:, rx] for ry, rx in corners]
        sm_y = gy * (gx * sy[0] + fx * sy[1]) + fy * (gx * sy[2] + fx * sy[3])
        sm_x = gy * (gx * sx[0] + fx * sx[1]) + fy * (gx * sx[2] + fx * sx[3])
        v = None
        for c, kk in enumerate(kks):
            dy, dx = fr.cand_y[kk], fr.cand_x[kk]
            fyk = torch.clamp(sm_y - dy.to(torch.float32), 0.0, 1.0)[..., None]
            fxk = torch.clamp(sm_x - dx.to(torch.float32), 0.0, 1.0)[..., None]
            r0 = (out_rows + dy).clamp(0, h - 1)
            r1 = (out_rows + dy + 1).clamp(0, h - 1)
            c0 = (cols + dx).clamp(0, w - 1)
            c1 = (cols + dx + 1).clamp(0, w - 1)
            p00, p01, p10, p11 = src[r0, c0], src[r0, c1], src[r1, c0], src[r1, c1]
            top = p00 + fxk * (p01 - p00)
            bot = p10 + fxk * (p11 - p10)
            term = bw[c][..., None] * (top + fyk * (bot - top))
            v = term if v is None else v + term
        acc = v * fr.weight if acc is None else acc + v * fr.weight
    return torch.round(torch.clamp(acc, 0.0, 255.0)).to(torch.uint8)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def check_inputs(a, b, tiles, tile: tuple, k: int) -> None:
    for name, x in (("a", a), ("b", b)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8:
            raise TypeError(f"{name}: expected a uint8 torch.Tensor")
        if x.dim() != 3 or x.shape[-1] != 4:
            raise ValueError(f"{name}: expected [H, W, 4], got {tuple(x.shape)}")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} on {a.device} and b {tuple(b.shape)} on {b.device}")
    h, w = a.shape[0], a.shape[1]
    th, tw = tile
    if th < 1 or tw < 1 or h % th or w % tw:
        raise ValueError(f"shape ({h}, {w}) must tile by {tuple(tile)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    if w >= MAX_WIDTH or h // th + 1 > MAX_CELL_ROWS:
        raise ValueError(f"shape ({h}, {w}) with tile {tuple(tile)}: the kernel takes widths below "
                         f"{MAX_WIDTH} and at most {MAX_CELL_ROWS - 1} tile rows")
    want = (h // th, w // tw, 2)
    if not isinstance(tiles, torch.Tensor) or tiles.dtype != torch.float32:
        raise TypeError("tiles: expected a float32 torch.Tensor")
    if tuple(tiles.shape) != want or tiles.device != a.device:
        raise ValueError(f"tiles: expected {want} on {a.device}, got {tuple(tiles.shape)} on {tiles.device}")


def reciprocal(n: int) -> float:
    """f32(1/n): the fractions' scale, and the kernel's divisor for cell
    columns."""
    return float(np.float32(1.0 / n))


def pack_inputs(frames) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both frames' inputs as the kernel reads them: tiles f32 [2, Ty, Tx, 2]
    (x, y), assign int32 [2, Ty, Tx], cand int32 [2, 2, K] (y, then x)."""
    tiles = torch.stack([f.tiles for f in frames]).contiguous()
    assign = torch.stack([f.assign for f in frames]).to(torch.int32).contiguous()
    cand = torch.stack(
        [torch.stack([f.cand_y, f.cand_x]) for f in frames]
    ).to(torch.int32).contiguous()
    return tiles, assign, cand


def _launch(a: torch.Tensor, b: torch.Tensor, frames, packed, tile: tuple, k: int,
            row0: int = 0, rows: int | None = None) -> torch.Tensor:
    """One launch of the kernel on `packed` (from `pack_inputs(frames)`), for
    output rows row0 .. row0 + rows − 1 (the whole frame by default)."""
    if a.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs CUDA tensors, got {a.device}")
    from nu_scaler_tpu_torch.kernels import _build

    lib = _build.load_library("soft_warp")
    h, w = a.shape[0], a.shape[1]
    rows = h - row0 if rows is None else rows
    th, tw = tile
    a, b = a.contiguous(), b.contiguous()
    tiles, assign, cand = packed
    out = torch.empty((rows, w, 4), dtype=torch.uint8, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.nu_soft_warp_blend(
        a.device.index or 0, a.data_ptr(), b.data_ptr(), h, w,
        tiles.data_ptr(), assign.data_ptr(), cand.data_ptr(), k,
        th, tw, reciprocal(th), reciprocal(tw),
        frames[0].weight, frames[1].weight, row0, rows, out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"soft_warp_blend launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})"
        )
    return out


def soft_warp_blend(
    a: torch.Tensor, b: torch.Tensor, tiles: torch.Tensor, t: float,
    tile: tuple = (8, 128), rng: int = 48, k: int = 8,
) -> torch.Tensor:
    """Overlapped-tile MC blend: u8 [H, W, 4] × 2 + tile-mean motion
    f32 [H/th, W/tw, 2] (x, y) of the step A→B + time t → u8 [H, W, 4].
    H and W must divide by the tile. Alpha is motion-compensated with RGB."""
    tile = tuple(tile)
    check_inputs(a, b, tiles, tile, k)
    return soft_warp_rows(a, b, frame_inputs(tiles, t, k, rng), tile, k, 0, a.shape[0])


def soft_warp_rows(a: torch.Tensor, b: torch.Tensor, frames, tile: tuple, k: int, row0: int,
                   rows: int, packed=None) -> torch.Tensor:
    """Output rows row0 .. row0 + rows − 1 of `soft_warp_blend`, u8
    [rows, W, 4], from the whole frame's front end `frames`
    (`frame_inputs`, on the frames' device) and, on a card, its packed form
    `packed` (`pack_inputs(frames)`; packed here when not given). Every pixel
    has the bytes of the whole frame's launch."""
    tile = tuple(tile)
    check_inputs(a, b, frames[0].tiles, tile, k)
    h = a.shape[0]
    if not (0 <= row0 and rows >= 1 and row0 + rows <= h):
        raise ValueError(f"rows {row0} .. {row0 + rows - 1} outside the frame's {h}")
    if a.device.type == "cpu":
        return soft_warp_plain(a, b, frames, tile, row0, rows)
    out = _launch(a, b, frames, pack_inputs(frames) if packed is None else packed, tile, k, row0, rows)
    launches["soft_warp_blend"] += 1
    return out
