"""Wrappers of the fused EASU + RCAS kernel (`csrc/fsr.cu`) and its plain
PyTorch version.

Two wrappers, one kernel (batch = grid z):

* `fsr`          u8 [H, W, 4]    → u8 [sH, sW, 4]     (replaces
  `nu_scaler_tpu/kernels/fsr_pallas.py:207` make_fsr_phase_kernel)
* `fsr_batched`  u8 [N, H, W, 4] → u8 [N, sH, sW, 4]  (replaces
  `fsr_pallas.py:246` make_fsr_phase_kernel_batched)

for an integer scale s in 1..`MAX_SCALE` and a sharpness. Alpha is 255.

What both compute, in the fp32 order of the TPU kernel (`fsr_pallas.py:65`
`_make_kernel`), on the input scaled by f32(1/255):

* EASU at every input pixel: the edge direction from the central
  differences ((1/3)·Σ|up − down|, (1/3)·Σ|left − right| over RGB), then for
  each of the s² output phases (py, px) the 4×4 taps at rows −1..+2 and
  columns −1..+2 (edge-clamped), weighted by FsrCubic(|base − offs|) with
  base = tx·wx + ty·wy and offs = ((px + 0.5)/s)·wx + ((py + 0.5)/s)·wy,
  normalised, and mixed toward the centre by the sharpness when it exceeds
  1e-3; luma 0.299·r + 0.587·g + 0.114·b.
* RCAS at every output pixel of the interleaved image: its four raster
  neighbours (other phases of the same or an adjacent input pixel; at the
  output image's edge the centre itself), strength = sharp·(1 −
  smoothstep(0, 0.2) of the luma contrast), out = c + (4c − t − b − l − r)·
  strength, packed as trunc(clip(out, 0, 1)·255).

The TPU kernel's planar f32 input, edge padding and phase planes (with the
banded interleave outside it) are gone: the kernel reads RGBA u8 and writes
raster RGBA u8. The plain version uses elementwise ops and gathers only (no
matmul, so no TF32 setting reaches it). A wrapper given a CPU tensor runs
the plain version; given a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

# Launches per wrapper since the last `reset_launches()`; a wrapper adds one
# where it launches its kernel and nowhere else.
launches = {"fsr": 0, "fsr_batched": 0}

MAX_SCALE = 4  # the API's upscale_scale range ends at 4
# the sharpness mix of EASU runs only above this (fsr_pallas.py:124)
SHARP_MIX_MIN = 1e-3

_F = np.float32
INV_255 = float(_F(1.0 / 255.0))
THIRD = float(_F(1.0 / 3.0))
EPS = float(_F(1e-4))
LUMA = tuple(float(_F(v)) for v in (0.299, 0.587, 0.114))


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def shift_edge(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """``out[i] = x[clip(i + d, 0, n − 1)]`` along `dim`."""
    if d == 0:
        return x
    n = x.shape[dim]
    return x.index_select(dim, torch.arange(n, device=x.device).add_(d).clamp_(0, n - 1))


def fsr_cubic(d: torch.Tensor) -> torch.Tensor:
    """FsrCubic on d ≥ 0, in the TPU kernel's order."""
    d2 = d * d
    d3 = d2 * d
    near = 2.0 - 1.5 * d - 0.5 * d3 + d2
    far = -0.5 * d + 2.5 * d2 - d3
    return torch.where(d <= 1.0, near, torch.where(d <= 2.0, far, torch.zeros_like(d)))


def _direction(rgb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(wx, wy) [N, H, W] of planar rgb [N, 3, H, W]."""
    ad = (shift_edge(rgb, -1, -2) - shift_edge(rgb, 1, -2)).abs()
    vgx = (ad[:, 0] + ad[:, 1] + ad[:, 2]) * THIRD
    ad = (shift_edge(rgb, -1, -1) - shift_edge(rgb, 1, -1)).abs()
    vgy = (ad[:, 0] + ad[:, 1] + ad[:, 2]) * THIRD
    ax, ay = vgx + EPS, vgy + EPS
    # torch's CPU sqrt is not correctly rounded (0.5001 ULP); the square root
    # of the fp32 value taken in fp64 and rounded to fp32 is, as the kernel's
    # __fsqrt_rn and the TPU kernel's are
    norm = torch.sqrt((ax * ax + ay * ay).double()).float()
    dirx, diry = ax / norm, ay / norm
    wx = dirx.abs() / (dirx.abs() + diry.abs())
    return wx, 1.0 - wx


def _easu_phases(rgb: torch.Tensor, s: int, sharp: float) -> torch.Tensor:
    """EASU of planar rgb [N, 3, H, W] in all s² phases → [s², N, 4, H, W]
    (r, g, b, luma), phase p = py·s + px."""
    wx, wy = _direction(rgb)
    dev = rgb.device
    ph = [((px + 0.5) / s, (py + 0.5) / s) for py in range(s) for px in range(s)]
    cx = torch.tensor([float(_F(a)) for a, _ in ph], device=dev).reshape(-1, 1, 1, 1)
    cy = torch.tensor([float(_F(b)) for _, b in ph], device=dev).reshape(-1, 1, 1, 1)
    offs = cx * wx + cy * wy  # [s², N, H, W]
    sum_c = torch.zeros((s * s, *rgb.shape), dtype=torch.float32, device=dev)
    sum_w = torch.zeros_like(offs)
    for ty in range(4):
        row = shift_edge(rgb, ty - 1, -2)
        for tx in range(4):
            tap = shift_edge(row, tx - 1, -1)
            base = float(tx) * wx + float(ty) * wy
            w = fsr_cubic((base - offs).abs())
            sum_w = sum_w + w
            sum_c = sum_c + tap * w[:, :, None]
    col = sum_c / torch.clamp_min(sum_w, EPS)[:, :, None]
    if sharp > SHARP_MIX_MIN:
        col = col + (rgb - col) * float(_F(sharp))
    lum = (LUMA[0] * col[:, :, 0] + LUMA[1] * col[:, :, 1]) + LUMA[2] * col[:, :, 2]
    return torch.cat([col, lum[:, :, None]], dim=2)


def _interleave(phases: torch.Tensor, s: int) -> torch.Tensor:
    """[s², N, C, H, W] phase planes → raster [N, C, s·H, s·W]."""
    _, n, c, h, w = phases.shape
    x = phases.reshape(s, s, n, c, h, w).permute(2, 3, 4, 0, 5, 1)
    return x.reshape(n, c, s * h, s * w)


def _rcas(e: torch.Tensor, sharp: float) -> torch.Tensor:
    """RCAS of raster [N, 4, OH, OW] (r, g, b, luma) with neighbours
    clamped at the image edge (there the centre) → RGB [N, 3, OH, OW]."""
    nb = [shift_edge(e, -1, -2), shift_edge(e, 1, -2), shift_edge(e, -1, -1), shift_edge(e, 1, -1)]
    lc, (lt, lb, ll, lr) = e[:, 3], (x[:, 3] for x in nb)
    min_l = torch.minimum(torch.minimum(torch.minimum(lt, lb), torch.minimum(ll, lr)), lc)
    max_l = torch.maximum(torch.maximum(torch.maximum(lt, lb), torch.maximum(ll, lr)), lc)
    t = torch.clamp((max_l - min_l) * 5.0, 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    strength = float(_F(sharp)) * (1.0 - smooth)
    cen = e[:, :3]
    top, bot, lef, rig = (x[:, :3] for x in nb)
    lap = 4.0 * cen - top - bot - lef - rig
    return cen + lap * strength[:, None]


def pack_rgba(rgb_p: torch.Tensor) -> torch.Tensor:
    """Planar f32 [N, 3, H, W] in [0, 1] → RGBA u8 [N, H, W, 4] by
    trunc(clip(·, 0, 1)·255), alpha 255."""
    u8 = torch.trunc(torch.clamp(rgb_p, 0.0, 1.0) * 255.0).to(torch.uint8)
    alpha = torch.full_like(u8[:, :1], 255)
    return torch.cat([u8, alpha], dim=1).permute(0, 2, 3, 1).contiguous()


def fsr_plain(src: torch.Tensor, scale: int, sharp: float) -> torch.Tensor:
    """The kernel's function in PyTorch ops: u8 [(N,) H, W, 4] →
    u8 [(N,) s·H, s·W, 4]."""
    x = src if src.dim() == 4 else src[None]
    rgb = x[..., :3].permute(0, 3, 1, 2).to(torch.float32) * INV_255
    e = _interleave(_easu_phases(rgb, scale, sharp), scale)
    out = pack_rgba(_rcas(e, sharp))
    return out if src.dim() == 4 else out[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def check_input(src: torch.Tensor, rank: int, scale: int) -> None:
    if not isinstance(src, torch.Tensor) or src.dtype != torch.uint8:
        raise TypeError("src: expected a uint8 torch.Tensor")
    if src.dim() != rank or src.shape[-1] != 4 or 0 in src.shape:
        want = "[N, H, W, 4]" if rank == 4 else "[H, W, 4]"
        raise ValueError(f"src: expected {want}, got {tuple(src.shape)}")
    if not isinstance(scale, int) or not 1 <= scale <= MAX_SCALE:
        raise ValueError(f"the FSR kernel takes an integer scale in 1..{MAX_SCALE}, got {scale!r}")


def _launch(src: torch.Tensor, scale: int, sharp: float) -> torch.Tensor:
    """One launch over a batch u8 [N, H, W, 4] → u8 [N, sH, sW, 4]."""
    if src.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs a CUDA tensor, got {src.device}")
    from nu_scaler_tpu_torch.kernels import _build

    lib = _build.load_library("fsr")
    src = src.contiguous()
    n, h, w = src.shape[0], src.shape[1], src.shape[2]
    out = torch.empty((n, scale * h, scale * w, 4), dtype=torch.uint8, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.nu_fsr(
        src.device.index or 0, src.data_ptr(), n, h, w, scale,
        float(_F(sharp)), int(sharp > SHARP_MIX_MIN), out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"fsr launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})")
    return out


def fsr(src: torch.Tensor, scale: int, sharp: float) -> torch.Tensor:
    """u8 [H, W, 4] → u8 [s·H, s·W, 4]: EASU + RCAS, one launch."""
    check_input(src, 3, scale)
    if src.device.type == "cpu":
        return fsr_plain(src, scale, sharp)
    out = _launch(src[None], scale, sharp)[0]
    launches["fsr"] += 1
    return out


def fsr_batched(src: torch.Tensor, scale: int, sharp: float) -> torch.Tensor:
    """u8 [N, H, W, 4] → u8 [N, s·H, s·W, 4] in one launch (batch = grid z)."""
    check_input(src, 4, scale)
    if src.device.type == "cpu":
        return fsr_plain(src, scale, sharp)
    out = _launch(src, scale, sharp)
    launches["fsr_batched"] += 1
    return out
