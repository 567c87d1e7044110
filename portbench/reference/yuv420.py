"""Plain reference of the 4:2:0 link: BT.601 full-swing conversions.

The numpy functions are frozen copies of the golden converters of
`capture/video.py` (the traffic generator makes the 4:2:0 input planes with
`rgba_to_yuv420_np`). The torch functions take the same operations in the
same order on the card, in `dtype`: float32 is the reference, a lower one its
control. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def yuv420_to_rgba_np(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BT.601 full-swing YUV420 → RGBA u8."""
    h, w = y.shape
    uf = u.repeat(2, axis=0).repeat(2, axis=1)[:h, :w].astype(np.float32) - 128.0
    vf = v.repeat(2, axis=0).repeat(2, axis=1)[:h, :w].astype(np.float32) - 128.0
    yf = y.astype(np.float32)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = np.clip(yf + 1.402 * vf, 0, 255)
    out[..., 1] = np.clip(yf - 0.344136 * uf - 0.714136 * vf, 0, 255)
    out[..., 2] = np.clip(yf + 1.772 * uf, 0, 255)
    out[..., 3] = 255
    return out


def rgba_to_yuv420_np(rgba: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    r = rgba[..., 0].astype(np.float32)
    g = rgba[..., 1].astype(np.float32)
    b = rgba[..., 2].astype(np.float32)
    y = np.clip(0.299 * r + 0.587 * g + 0.114 * b, 0, 255).astype(np.uint8)
    u = np.clip(-0.168736 * r - 0.331264 * g + 0.5 * b + 128.0, 0, 255)
    v = np.clip(0.5 * r - 0.418688 * g - 0.081312 * b + 128.0, 0, 255)
    h2, w2 = (rgba.shape[0] // 2) * 2, (rgba.shape[1] // 2) * 2
    u420 = u[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3)).astype(np.uint8)
    v420 = v[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3)).astype(np.uint8)
    return y, u420, v420


def _up2(p: torch.Tensor) -> torch.Tensor:
    return p.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def yuv420_to_rgba(y, u, v, dtype=torch.float32) -> torch.Tensor:
    """u8 planes (tensors) → RGBA u8, the golden's operations in `dtype`."""
    uf = _up2(u).to(dtype) - 128.0
    vf = _up2(v).to(dtype) - 128.0
    yf = y.to(dtype)
    r = torch.clamp(yf + 1.402 * vf, 0, 255)
    g = torch.clamp(yf - 0.344136 * uf - 0.714136 * vf, 0, 255)
    b = torch.clamp(yf + 1.772 * uf, 0, 255)
    a = torch.full_like(yf, 255)
    return torch.stack([r, g, b, a], dim=-1).to(torch.uint8)


def rgba_to_yuv420(rgba: torch.Tensor, dtype=torch.float32):
    """RGBA u8 (tensor) → (y, u, v) u8, the golden's operations in `dtype`:
    per-pixel chroma clipped, then the 2x2 mean, truncated."""
    r, g, b = (rgba[..., c].to(dtype) for c in range(3))
    y = torch.clamp(0.299 * r + 0.587 * g + 0.114 * b, 0, 255).to(torch.uint8)
    u = torch.clamp(-0.168736 * r - 0.331264 * g + 0.5 * b + 128.0, 0, 255)
    v = torch.clamp(0.5 * r - 0.418688 * g - 0.081312 * b + 128.0, 0, 255)
    h2, w2 = rgba.shape[0] // 2, rgba.shape[1] // 2

    def mean2x2(p):
        q = p[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2)
        return ((q[:, 0, :, 0] + q[:, 0, :, 1]) + (q[:, 1, :, 0] + q[:, 1, :, 1])) / 4.0

    return y, mean2x2(u).to(torch.uint8), mean2x2(v).to(torch.uint8)
