"""Frame interpolation ops of the port. This slice carries the zero-flow
cross-fade ("blend") only; the motion-compensated modes are ROADMAP queue 1,
item 8."""

from __future__ import annotations

import torch

from nu_scaler_tpu_torch.device import resolve_device

MODES = ("blend", "flow", "flow_soft", "flow_soft_ref", "flow_exact")


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
    if mode != "blend":
        raise NotImplementedError(
            f"interpolation mode {mode!r} is not ported yet (ROADMAP queue 1, item 8)"
        )


def make_interpolator(height: int, width: int, mode: str = "blend", device=None):
    """``(frame_a, frame_b, t) -> mid`` u8 tensors on `device`, for a fixed
    size; mode "blend" only in this slice."""
    check_mode(mode)
    dev = resolve_device(device)

    def fn(a, b, t):
        for x in (a, b):
            if tuple(x.shape) != (height, width, 4):
                raise ValueError(f"expected [{height}, {width}, 4], got {tuple(x.shape)}")
        return blend_only(a.to(dev), b.to(dev), t)

    return fn
