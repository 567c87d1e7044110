"""FSR upscaling (EASU + RCAS) of the port: the counterpart of
`nu_scaler_tpu/ops/fsr.py`.

An integer scale s in 1..4, equal on both axes, runs the fused kernel
(`kernels/fsr_cuda.py` → `csrc/fsr.cu`): EASU and RCAS in one launch, fp32
between them, the batch in the same launch. Every other scale composes the
general EASU (`easu`, trunc-packed to u8) and `rcas` in plain PyTorch, as
the JAX package's XLA path does: the u8 round trip between the two passes
belongs to that path. Frames are RGBA u8 ``[H, W, 4]`` or ``[N, H, W, 4]``;
alpha comes out 255.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.kernels.fsr_cuda import (
    EPS,
    INV_255,
    LUMA,
    MAX_SCALE,
    SHARP_MIX_MIN,
    fsr,
    fsr_batched,
    fsr_cubic,
    pack_rgba,
    shift_edge,
)
from nu_scaler_tpu_torch.kernels.reference import FSR_SHARPNESS
from nu_scaler_tpu_torch.ops.resample import to_device_u8

__all__ = ["easu", "rcas", "fsr_upscale", "make_fsr_upscaler", "FSR_SHARPNESS"]


def _divisor(value: float, device: torch.device) -> torch.Tensor:
    """`value` as an fp32 tensor on `device`: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, which rounds otherwise than
    the true division of the CPU and of the JAX function."""
    return torch.full((), value, dtype=torch.float32, device=device)


def sharpness(quality: str) -> float:
    """The tier's sharpness; an unknown tier takes "quality"'s."""
    return FSR_SHARPNESS.get((quality or "").lower(), FSR_SHARPNESS["quality"])


def easu(img_u8: torch.Tensor, out_h: int, out_w: int, sharpness: float) -> torch.Tensor:
    """Edge Adaptive Spatial Upsampling at any scale, trunc-packed: the JAX
    package's `_easu_general` in its fp32 order. u8 [..., H, W, 4] →
    u8 [..., out_h, out_w, 4]. Output pixel (y, x) maps to input
    ((y + 0.5)·H/out_h, (x + 0.5)·W/out_w); the direction comes from the
    central differences at its integer part, the 4×4 taps from one row and
    column above it, and the fractions weigh them through FsrCubic."""
    in_h, in_w = img_u8.shape[-3], img_u8.shape[-2]
    dev = img_u8.device
    rgb = img_u8[..., :3].to(torch.float32) * INV_255

    def axis(n_out: int, n_in: int):
        o = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * float(np.float32(n_in / n_out))
        return o.to(torch.int64), o - torch.floor(o)

    cy, fr_y = axis(out_h, in_h)
    cx, fr_x = axis(out_w, in_w)
    cy, fr_y = cy[:, None], fr_y[:, None]
    cx, fr_x = cx[None, :], fr_x[None, :]

    def fetch(py, px):
        return rgb[..., py.clamp(0, in_h - 1), px.clamp(0, in_w - 1), :]

    def grad(d):
        a = d.abs()
        return (a[..., 0] + a[..., 1] + a[..., 2]) / _divisor(3.0, dev)

    vgx = grad(fetch(cy - 1, cx) - fetch(cy + 1, cx))
    vgy = grad(fetch(cy, cx - 1) - fetch(cy, cx + 1))
    ax, ay = vgx + EPS, vgy + EPS
    # fp32 sqrt correctly rounded (see fsr_cuda._direction)
    norm = torch.sqrt((ax * ax + ay * ay).double()).float()
    dirx, diry = ax / norm, ay / norm
    wx = dirx.abs() / (dirx.abs() + diry.abs())
    wy = 1.0 - wx
    sum_c = torch.zeros((*wx.shape, 3), dtype=torch.float32, device=dev)
    sum_w = torch.zeros_like(wx)
    for ty in range(4):
        for tx in range(4):
            wgt = fsr_cubic(((float(tx) - fr_x) * wx + (float(ty) - fr_y) * wy).abs())
            sum_c = sum_c + fetch(cy - 1 + ty, cx - 1 + tx) * wgt[..., None]
            sum_w = sum_w + wgt
    color = sum_c / torch.clamp_min(sum_w, EPS)[..., None]
    if sharpness > SHARP_MIX_MIN:
        color = color + (fetch(cy, cx) - color) * float(np.float32(sharpness))
    u8 = torch.trunc(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)
    return torch.cat([u8, torch.full_like(u8[..., :1], 255)], dim=-1)


def rcas(img_u8: torch.Tensor, sharpness: float) -> torch.Tensor:
    """Robust Contrast Adaptive Sharpening of u8 [..., H, W, 4] → u8 (trunc
    packed, alpha 255): the JAX package's `rcas` in its fp32 order, with
    neighbours clamped at the image edge."""
    x = img_u8 if img_u8.dim() == 4 else img_u8[None]
    center = x[..., :3].permute(0, 3, 1, 2).to(torch.float32) * INV_255
    nb = [shift_edge(center, -1, -2), shift_edge(center, 1, -2),
          shift_edge(center, -1, -1), shift_edge(center, 1, -1)]
    lums = [(v[:, 0] * LUMA[0] + v[:, 1] * LUMA[1]) + v[:, 2] * LUMA[2] for v in (center, *nb)]
    min_l = functools.reduce(torch.minimum, lums)
    max_l = functools.reduce(torch.maximum, lums)
    t = torch.clamp((max_l - min_l) / _divisor(0.2, center.device), 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    strength = float(np.float32(sharpness)) * (1.0 - smooth)
    top, bottom, left, right = nb
    lap = 4.0 * center - top - bottom - left - right
    out = pack_rgba(center + lap * strength[:, None])
    return out if img_u8.dim() == 4 else out[0]


def integer_scale(in_h: int, in_w: int, out_h: int, out_w: int):
    """The kernel's scale s when out = s·in on both axes with s in
    1..MAX_SCALE, else None (the general path)."""
    s = out_h // in_h
    if out_h == s * in_h and out_w == s * in_w and 1 <= s <= MAX_SCALE:
        return s
    return None


class FsrUpscaler:
    """``u8 [H, W, 4] → u8 [OH, OW, 4]``, or a batch ``[N, H, W, 4]`` in one
    launch; outputs stay on the device."""

    def __init__(self, in_h: int, in_w: int, out_h: int, out_w: int, quality: str, device=None):
        self.in_hw = (in_h, in_w)
        self.out_hw = (out_h, out_w)
        self.sharp = sharpness(quality)
        self.device = resolve_device(device)
        self.scale = integer_scale(in_h, in_w, out_h, out_w)

    def __call__(self, img) -> torch.Tensor:
        x = to_device_u8(img, self.device)
        if x.dim() not in (3, 4) or tuple(x.shape[-3:]) != (*self.in_hw, 4):
            raise ValueError(f"expected [(N,) {self.in_hw[0]}, {self.in_hw[1]}, 4], got {tuple(x.shape)}")
        if self.scale is None:
            return rcas(easu(x, *self.out_hw, self.sharp), self.sharp)
        if x.dim() == 3:
            return fsr(x, self.scale, self.sharp)
        return fsr_batched(x, self.scale, self.sharp)


@functools.lru_cache(maxsize=64)
def _cached_upscaler(in_h, in_w, out_h, out_w, quality, device) -> FsrUpscaler:
    return FsrUpscaler(in_h, in_w, out_h, out_w, quality, device)


def make_fsr_upscaler(
    in_h: int, in_w: int, out_h: int, out_w: int, quality: str = "quality", device=None
) -> FsrUpscaler:
    """Shape-specialised FSR upscaler on `device` (the card unless "cpu"),
    cached per (shape, quality, device)."""
    return _cached_upscaler(in_h, in_w, out_h, out_w, quality, resolve_device(device))


def fsr_upscale(img_u8, out_h: int, out_w: int, quality: str = "quality", device=None) -> torch.Tensor:
    """One-shot EASU + RCAS upscale of one frame or a batch on `device`."""
    in_h, in_w = np.shape(img_u8)[-3], np.shape(img_u8)[-2]
    return make_fsr_upscaler(in_h, in_w, out_h, out_w, quality, device)(img_u8)
