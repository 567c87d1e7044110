"""4:2:0 ↔ RGBA conversion on the device: the live link's transfer format,
the counterpart of `nu_scaler_tpu/ops/color.py`.

The live pipeline can take planar 4:2:0 capture frames (1.5 bytes a pixel
across the link instead of 4) and hand back 4:2:0 planes and / or a
preview-sized frame, converting on the card (`LivePipeline`'s `ingest_fn`
and `deliver_fn`).

Numerics follow the BT.601 full-swing goldens of `capture/video.py`
(`_yuv420_to_rgba`, `_rgba_to_yuv420`):

* the chroma 2×2 means are two halvings of sums of u8 values, exact in fp32
  in any order; the 2× nearest upsample is a repeat. (The JAX package forms
  both as banded 0 / 0.5 / 1 matmuls, because its TPU has no strided access;
  here they are strided slices and `repeat_interleave`.)
* chroma is taken at quarter resolution from the mean RGB: the colour matrix
  is affine in RGB, so chroma(mean(rgb)) equals mean(chroma(rgb)) in real
  arithmetic.
* every affine term is its own fp32 operation, in the JAX order
  (``-0.168736·r2 − 0.331264·g2 + 0.5·b2 + 128``, left to right), so no FMA
  forms; then clip and a truncating conversion to u8. The JAX functions,
  compiled by XLA, may contract a product and a sum into an FMA: the two
  sides then differ by a truncation tie, at most 1 LSB.
"""

from __future__ import annotations

import functools

import torch

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.ops import resample
from nu_scaler_tpu_torch.ops.resample import to_device_u8
from nu_scaler_tpu_torch.utils.tracing import span

# BT.601 full-swing (capture/video.py)
_KR, _KG, _KB = 0.299, 0.587, 0.114


def _check_even(h: int, w: int) -> None:
    if h % 2 or w % 2:
        raise ValueError(f"4:2:0 needs even dims, got {(h, w)}")


def _check_shape(x: torch.Tensor, shape: tuple) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"expected {list(shape)}, got {list(x.shape)}")


def _up2(p: torch.Tensor) -> torch.Tensor:
    """2× nearest upsample of a [h, w] plane."""
    return p.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def _mean2x2(x: torch.Tensor) -> torch.Tensor:
    """2×2 means of a [H, W] fp32 plane of integers, as two halvings."""
    rows = (x[0::2] + x[1::2]) * 0.5
    return (rows[:, 0::2] + rows[:, 1::2]) * 0.5


@functools.lru_cache(maxsize=16)
def _yuv420_to_rgba(h: int, w: int, dev: torch.device):
    _check_even(h, w)

    def fn(y, u, v) -> torch.Tensor:
        with span("nu.ops.color.ingest"):
            y, u, v = (to_device_u8(p, dev) for p in (y, u, v))
            _check_shape(y, (h, w))
            _check_shape(u, (h // 2, w // 2))
            _check_shape(v, (h // 2, w // 2))
            yf = y.to(torch.float32)
            uf = _up2(u.to(torch.float32) - 128.0)
            vf = _up2(v.to(torch.float32) - 128.0)
            r = yf + vf * 1.402
            g = yf - uf * 0.344136 - vf * 0.714136
            b = yf + uf * 1.772
            out = torch.stack([r, g, b, torch.full_like(yf, 255.0)], dim=-1)
            return torch.clamp(out, 0.0, 255.0).to(torch.uint8)

    return fn


def make_yuv420_to_rgba(h: int, w: int, device=None):
    """``(y [H, W], u [H/2, W/2], v [H/2, W/2]) u8 → RGBA u8 [H, W, 4]`` on
    `device` (the card unless "cpu"); the golden `_yuv420_to_rgba`'s
    operations in its order. Odd dims raise ValueError."""
    return _yuv420_to_rgba(h, w, resolve_device(device))


@functools.lru_cache(maxsize=16)
def _rgba_to_yuv420(h: int, w: int, dev: torch.device):
    _check_even(h, w)

    def fn(rgba) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = to_device_u8(rgba, dev)
        _check_shape(x, (h, w, 4))
        rf, gf, bf = (x[..., c].to(torch.float32) for c in range(3))
        y = torch.clamp(rf * _KR + gf * _KG + bf * _KB, 0.0, 255.0).to(torch.uint8)
        r2, g2, b2 = _mean2x2(rf), _mean2x2(gf), _mean2x2(bf)
        u = torch.clamp(r2 * -0.168736 - g2 * 0.331264 + b2 * 0.5 + 128.0, 0.0, 255.0)
        v = torch.clamp(r2 * 0.5 - g2 * 0.418688 - b2 * 0.081312 + 128.0, 0.0, 255.0)
        return y, u.to(torch.uint8), v.to(torch.uint8)

    return fn


def make_rgba_to_yuv420(h: int, w: int, device=None):
    """``RGBA u8 [H, W, 4] → (y [H, W], u [H/2, W/2], v [H/2, W/2])`` u8 on
    `device` (the card unless "cpu"). Within 1 LSB of the golden
    `_rgba_to_yuv420`, which takes fp32 chroma per pixel, clips it, then
    means it; here the exact integer RGB is meaned first. Odd dims raise
    ValueError."""
    return _rgba_to_yuv420(h, w, resolve_device(device))


@functools.lru_cache(maxsize=16)
def _delivery_fn(out_h: int, out_w: int, fmt: str, preview_h: int, dev: torch.device):
    steps = []
    h, w = out_h, out_w
    if preview_h and preview_h < out_h:
        pw = max(2, round(out_w * preview_h / out_h / 2) * 2)
        ph = max(2, (preview_h // 2) * 2)
        steps.append(resample.make_resampler(out_h, out_w, ph, pw, "area", dev))
        h, w = ph, pw
    if fmt == "yuv420":
        steps.append(make_rgba_to_yuv420(h, w, dev))
    elif fmt != "rgba":
        raise ValueError(f"unknown delivery format {fmt!r}")
    if not steps:
        return None

    def fn(rgba):
        with span("nu.ops.color.deliver"):
            out = rgba
            for s in steps:
                out = s(out)
            return out

    fn.out_hw = (h, w)
    fn.fmt = fmt
    return fn


def make_delivery_fn(out_h: int, out_w: int, fmt: str = "yuv420", preview_h: int = 0,
                     device=None):
    """The live loop's delivery converter on `device` (the card unless
    "cpu"): RGBA u8 [out_h, out_w, 4] → the payload fetched to the host.

    fmt: "rgba" (identity, 4 bytes a pixel) or "yuv420" (1.5 bytes a pixel,
    a (y, u, v) tuple). ``preview_h > 0`` first resamples to the preview
    height ("area", on the resample kernel), the same aspect, even sides.
    Returns None for the identity, so that the caller skips it; otherwise
    the function carries ``.out_hw`` (the payload's frame size) and
    ``.fmt``."""
    return _delivery_fn(out_h, out_w, fmt, int(preview_h), resolve_device(device))


def payload_bytes(fmt: str, h: int, w: int) -> int:
    """Host-transfer bytes a frame in the delivery format."""
    return h * w * 4 if fmt == "rgba" else h * w + 2 * (h // 2) * (w // 2)
