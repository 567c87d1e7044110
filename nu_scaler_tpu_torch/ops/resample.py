"""Resampling ops of the port: the counterpart of `nu_scaler_tpu/ops/resample.py`.

Every algorithm (nearest and bilinear with their WGSL top-left alignment and
trunc packing included) is a per-axis [O, I] weight matrix, carried to the
device as a compact tap table and run by the fused resample kernel
(`kernels/resample_cuda.py`). The tap-table kernel takes any scale, so the JAX
package's split between tiling (banded) and non-tiling (dense) scales has no
counterpart here.

The u8 functions take and return RGBA uint8 ``[H, W, 4]`` (batch variants
``[N, H, W, 4]``) tensors, the byte contract of the reference API.
`resize_f32` resamples float planes (flow fields) in plain PyTorch.
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.kernels import reference as ref
from nu_scaler_tpu_torch.kernels.resample_cuda import (
    ResamplePlan,
    resample_fused,
    resample_fused_batched,
    resample_fused_blend,
    taps_from_matrix,
)

# Algorithms the string-typed API accepts. "nearest"/"bilinear" are the live
# set of the reference; the rest are its legacy tiers. Unknown strings fall
# back to nearest, matching the reference's silent-default parsing.
ALGORITHMS = (
    "nearest",
    "bilinear",
    "bicubic",
    "lanczos2",
    "lanczos3",
    "mitchell",
    "area",
)


def normalize_algorithm(name: str) -> str:
    """Case-insensitive parse with reference-compatible fallbacks."""
    n = (name or "").lower().replace(" ", "").replace("-", "").replace("_", "")
    aliases = {
        "nearestneighbor": "nearest",
        "balanced": "bicubic",  # legacy Balanced tier maps to Bicubic
        "catmullrom": "bicubic",
        "box": "area",
    }
    n = aliases.get(n, n)
    return n if n in ALGORITHMS else "nearest"


def quality_algorithm(quality: str) -> str:
    """Quality→algorithm map of the legacy BasicUpscaler
    (Nu_scale/src/upscale/common.rs:153-160)."""
    return {
        "ultra": "lanczos3",
        "quality": "lanczos2",
        "balanced": "bicubic",
        "performance": "bilinear",
    }.get((quality or "").lower(), "lanczos2")


@functools.lru_cache(maxsize=256)
def axis_weights(in_size: int, out_size: int, algorithm: str) -> np.ndarray:
    """Dense [out, in] float32 weights of one axis (the port's own copy of
    `reference.filter_weights`)."""
    return ref.filter_weights(in_size, out_size, algorithm)


@functools.lru_cache(maxsize=256)
def device_taps(device: torch.device, mat_fn, *args):
    """The tap table of the axis matrix ``mat_fn(*args)`` as (first + arange(K)
    int64 [O, K], weights f32 [O, K]) on `device`; cached, so that a hot loop
    makes no host-to-device copy."""
    first, weights = taps_from_matrix(mat_fn(*args))
    idx = first[:, None].astype(np.int64) + np.arange(weights.shape[1])[None, :]
    return torch.from_numpy(idx).to(device), torch.from_numpy(weights).to(device)


def apply_taps(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """``out[.., o, ..] = Σ_k w[o, k] · x[.., idx[o, k], ..]`` along `dim`, in
    fp32 elementwise ops: one gather, one product and one sum over the K
    taps. No matmul, so no TF32 setting of the caller can reach it."""
    idx, weights = taps
    dim = dim % x.ndim
    o, k = weights.shape
    g = x.index_select(dim, idx.reshape(-1)).unflatten(dim, (o, k))
    shape = [1] * g.ndim
    shape[dim], shape[dim + 1] = o, k
    return (g * weights.reshape(shape)).sum(dim + 1)


def resize_f32(
    x: torch.Tensor, out_h: int, out_w: int, algorithm: str = "bilinear_center"
) -> torch.Tensor:
    """Float resize of ``[..., H, W, C]`` planes (no u8 packing), rows first
    then columns, center-aligned bilinear by default — the counterpart of
    `nu_scaler_tpu/ops/resample.py` resize_f32, used for flow fields."""
    in_h, in_w = x.shape[-3], x.shape[-2]
    out = apply_taps(x, device_taps(x.device, ref.filter_weights, in_h, out_h, algorithm), -3)
    return apply_taps(out, device_taps(x.device, ref.filter_weights, in_w, out_w, algorithm), -2)


def to_device_u8(img: Union[np.ndarray, torch.Tensor], device: torch.device) -> torch.Tensor:
    """A u8 frame (numpy or torch) as a contiguous tensor on `device`."""
    if isinstance(img, torch.Tensor):
        if img.dtype != torch.uint8:
            raise TypeError(f"expected a uint8 frame, got {img.dtype}")
        return img.to(device).contiguous()
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected a uint8 frame, got {arr.dtype}")
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, copy=True, order="C")  # torch wants writable memory
    return torch.from_numpy(arr).to(device)


class Resampler:
    """``u8 [H,W,4] → u8 [OH,OW,4]`` (one kernel launch); also takes a
    leading batch ``[N,H,W,4]`` (one batched launch). Outputs stay on the
    device."""

    def __init__(
        self, in_h: int, in_w: int, out_h: int, out_w: int, algorithm: str, device: torch.device
    ) -> None:
        self.algorithm = normalize_algorithm(algorithm)
        self.device = resolve_device(device)
        self.plan = ResamplePlan(
            axis_weights(in_h, out_h, self.algorithm),
            axis_weights(in_w, out_w, self.algorithm),
            self.device,
        )

    def __call__(self, img) -> torch.Tensor:
        x = to_device_u8(img, self.device)
        if x.dim() == 3:
            return resample_fused(x, self.plan)
        if x.dim() == 4:
            return resample_fused_batched(x, self.plan)
        raise ValueError(f"expected [H, W, 4] or [N, H, W, 4], got {tuple(x.shape)}")


@functools.lru_cache(maxsize=64)
def _cached_resampler(in_h, in_w, out_h, out_w, algorithm, device) -> Resampler:
    return Resampler(in_h, in_w, out_h, out_w, algorithm, device)


def make_resampler(
    in_h: int, in_w: int, out_h: int, out_w: int, algorithm: str, device=None
) -> Resampler:
    """Shape-specialized resampler on `device` (the card unless "cpu");
    cached per (shape, algorithm, device)."""
    dev = resolve_device(device)
    return _cached_resampler(in_h, in_w, out_h, out_w, normalize_algorithm(algorithm), dev)


class FusedBlendStep:
    """The live step as one kernel launch: ``(cur [H,W,4], prev_up [OH,OW,4])
    → (cur_up, mid_t for each t)``, each mid the round-mix of prev_up and the
    truncated cur_up. ``prev_up=None`` (the first frame) runs the plain
    resample launch and returns ``(cur_up,)``. `time_t` is one float (2×
    interpolation, one mid) or a tuple of up to two (3× frame generation:
    (1/3, 2/3))."""

    def __init__(
        self, in_h: int, in_w: int, out_h: int, out_w: int, algorithm: str,
        time_t: Union[float, Sequence[float]] = 0.5, device=None,
    ) -> None:
        ts = time_t if isinstance(time_t, (tuple, list)) else (time_t,)
        self.ts = tuple(float(np.float32(t)) for t in ts)
        self.out_hw = (out_h, out_w)
        self.resampler = make_resampler(in_h, in_w, out_h, out_w, algorithm, device)
        self.device = self.resampler.device

    def __call__(self, cur, prev_up=None) -> tuple[torch.Tensor, ...]:
        x = to_device_u8(cur, self.device)
        if prev_up is None:
            return (resample_fused(x, self.resampler.plan),)
        return resample_fused_blend(x, prev_up, self.resampler.plan, self.ts)


def make_fused_blend(
    in_h: int, in_w: int, out_h: int, out_w: int, algorithm: str,
    time_t: Union[float, Sequence[float]] = 0.5, device=None,
) -> FusedBlendStep:
    """Counterpart of `make_pallas_fused_blend` with plain [OH,OW,4] outputs."""
    return FusedBlendStep(in_h, in_w, out_h, out_w, algorithm, time_t, device)


def upscale_frame(img_u8, out_h: int, out_w: int, algorithm: str = "bilinear", device=None):
    """One-shot convenience on `device`."""
    in_h, in_w = np.shape(img_u8)[-3], np.shape(img_u8)[-2]
    return make_resampler(in_h, in_w, out_h, out_w, algorithm, device)(img_u8)
