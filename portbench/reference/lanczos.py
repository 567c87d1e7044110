"""Plain reference of the classical path: the separable Lanczos-3 resample
and the cross-fade's round-mix, in plain PyTorch.

It follows the golden of the system this repo was modelled on: per axis a
center-aligned filter (src = (dst + 0.5)·in/out − 0.5, taps clamped to the
edge, each row normalised to 1, the weights rounded to float32), applied to
the frame in [0, 1] rows first and then columns, the result rounded to
float32, clipped to [0, 1], times 255 and truncated to u8 ("WGSL trunc
packing"). The mid at time t is clip(round(a + (b − a)·t)), ties to even
(rgba8unorm packing). `dtype` float64 is the reference; a lower one is its
control, every product and sum rounded to it.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def lanczos(x: np.ndarray, a: int) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return np.where(np.abs(x) < a, np.sinc(x) * np.sinc(x / a), 0.0)


def axis_taps(in_size: int, out_size: int, a: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """(source indices [out, K] clamped to the edge, float32 weights [out, K])
    of one axis; support widened by the ratio when shrinking."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    r = a * fscale
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(centers - r).astype(np.int64) + 1
    taps = lo[:, None] + np.arange(int(np.ceil(2 * r)) + 1)[None, :]
    w = lanczos((taps - centers[:, None]) / fscale, a)
    w = w / w.sum(axis=1, keepdims=True)
    return np.clip(taps, 0, in_size - 1), w.astype(np.float32)


class Lanczos3:
    """u8 RGBA [H, W, 4] → u8 RGBA [OH, OW, 4] on `device`, in `dtype`."""

    def __init__(self, in_h: int, in_w: int, out_h: int, out_w: int, device,
                 dtype=torch.float64) -> None:
        self.dtype = dtype
        self.axes = []
        for n_in, n_out in ((in_h, out_h), (in_w, out_w)):
            idx, w = axis_taps(n_in, n_out)
            self.axes.append((torch.from_numpy(idx).to(device),
                              torch.from_numpy(w).to(device).to(dtype)))

    def _axis(self, x: torch.Tensor, dim: int, taps) -> torch.Tensor:
        idx, w = taps
        shape = [1] * x.ndim
        shape[dim] = -1
        out = None
        for k in range(idx.shape[1]):
            term = x.index_select(dim, idx[:, k]) * w[:, k].reshape(shape)
            out = term if out is None else out + term
        return out

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        f = (img.to(torch.float32) / 255.0).to(self.dtype)  # the golden's float32 unpack
        f = self._axis(f, 0, self.axes[0])
        f = self._axis(f, 1, self.axes[1])
        return torch.trunc(torch.clamp(f.to(torch.float32), 0.0, 1.0) * 255.0).to(torch.uint8)


def mix(a: torch.Tensor, b: torch.Tensor, t: float, dtype=torch.float64) -> torch.Tensor:
    """clip(round(a + (b − a)·t)) of two u8 frames, ties to even, in `dtype`."""
    fa, fb = a.to(dtype), b.to(dtype)
    return torch.clamp(torch.round(fa + (fb - fa) * t), 0, 255).to(torch.uint8)


class Reference:
    """The blend configuration's reference: an input frame's payloads are its
    mids with the frame before (one per time t) and its own upscale."""

    def __init__(self, cfg: dict, device, control: bool = False) -> None:
        self.dtype = torch.bfloat16 if control else torch.float64
        self.ts = [float(t) for t in cfg["time_t"]]
        self.up = Lanczos3(cfg["in_h"], cfg["in_w"], cfg["out_h"], cfg["out_w"], device, self.dtype)

    def upscale(self, cur: torch.Tensor) -> torch.Tensor:
        return self.up(cur)

    def payloads(self, prev_up: torch.Tensor | None, up: torch.Tensor) -> list[torch.Tensor]:
        """A frame's payloads from its upscale and the one before (None for the
        first frame): the mids, one per time t, then the upscale."""
        if prev_up is None:
            return [up]
        return [mix(prev_up, up, t, self.dtype) for t in self.ts] + [up]

    def step_fn(self):
        """The reference in the program's place, as the pipeline's fused step:
        (cur, prev_up) → (cur_up, *mids); (cur, None) → (cur_up,)."""

        def step(cur, prev_up=None):
            up = self.up(cur)
            if prev_up is None:
                return (up,)
            return (up, *[mix(prev_up, up, t, self.dtype) for t in self.ts])

        return {"fused_step_fn": step}
