"""Training and evaluation data of the learned tier — the port of
`nu_scaler_tpu/models/data.py`.

`render_clip` draws procedural clips (multi-octave textures, a panning
camera, moving sprites, hard edges, a colour ramp), `clip_through_video_path`
round-trips them through the port's Y4M writer and reader (4:2:0 chroma, the
video path the upscaler serves), and `PairPool` cuts LR/HR crop pairs with
area downscaling. These are numpy copies of the JAX module's: the same seed
gives the same bytes and the same draws, in the same order.

`eval_vs_lanczos3` scores a net against the lanczos3 tier on held-out clips
(seeds 900+, disjoint from the training seeds 100..), its reference the
port's `make_resampler` (the `resample_fused` kernel on the card);
`eval_interp_refinement` scores "flow_soft_ref" against "flow_soft" through
the port's `make_interpolator`. Both run on `device`, the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, List, Tuple

import numpy as np
import torch

from nu_scaler_tpu_torch.capture.video import Y4MReader, Y4MWriter
from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.ops.metrics import psnr, ssim

EVAL_SEEDS = (900, 901, 902)  # held out: the pools render seeds 100..


def _smooth_noise(rng: np.random.Generator, h: int, w: int, octaves: int = 4) -> np.ndarray:
    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        s = 2 ** (octaves - o)
        small = rng.random((h // s + 2, w // s + 2)).astype(np.float32)
        big = np.kron(small, np.ones((s, s), np.float32))[:h, :w]
        img += big / (o + 1)
    img -= img.min()
    return img / max(img.max(), 1e-6)


def render_clip(h: int = 288, w: int = 512, frames: int = 8, seed: int = 0) -> List[np.ndarray]:
    """Procedural scene: a textured background under a camera pan, 1-3
    moving sprites (textured squares, hard-edged bars, smooth discs) and a
    colour ramp. Returns `frames` RGBA u8 arrays [h, w, 4]."""
    rng = np.random.default_rng(seed)
    margin = 48
    canvas = np.stack([_smooth_noise(rng, h + 2 * margin, w + 2 * margin) for _ in range(3)], -1)
    # hard detail: scattered edges and thin lines on the canvas
    for _ in range(12):
        y0 = rng.integers(0, h + margin)
        x0 = rng.integers(0, w + margin)
        ln = rng.integers(20, 120)
        col = rng.random(3).astype(np.float32)
        if rng.random() < 0.5:
            canvas[y0, x0: x0 + ln] = col
        else:
            canvas[y0: y0 + ln, x0] = col
    vy, vx = int(rng.integers(-2, 3)), int(rng.integers(-3, 4))
    sprites = []
    for _ in range(int(rng.integers(1, 4))):
        size = int(rng.integers(24, 64))
        kind = rng.integers(0, 3)
        if kind == 0:
            tex = np.stack([_smooth_noise(rng, size, size, 3) for _ in range(3)], -1)
        elif kind == 1:  # hard-edged two-tone bar
            tex = np.broadcast_to(rng.random(3).astype(np.float32), (size, size, 3)).copy()
            tex[:, size // 2:] = rng.random(3).astype(np.float32)
        else:  # smooth disc
            yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
            r = np.hypot(yy - size / 2, xx - size / 2) / (size / 2)
            tex = np.clip(1.0 - r, 0, 1)[..., None] * rng.random(3).astype(np.float32)
        sprites.append(dict(tex=tex.astype(np.float32), y=int(rng.integers(0, h - size)),
                            x=int(rng.integers(0, w - size)), vy=int(rng.integers(-3, 4)),
                            vx=int(rng.integers(-4, 5)), size=size))
    ramp = np.linspace(0, 0.15, w, dtype=np.float32)[None, :, None] * rng.random(3)

    out = []
    for k in range(frames):
        oy, ox = margin + k * vy, margin + k * vx
        view = canvas[oy: oy + h, ox: ox + w].copy()
        for sp in sprites:
            size = sp["size"]
            py = int(np.clip(sp["y"] + k * sp["vy"], 0, h - size))
            px = int(np.clip(sp["x"] + k * sp["vx"], 0, w - size))
            view[py: py + size, px: px + size] = sp["tex"]
        view = np.clip(view + ramp, 0, 1)
        fr = np.empty((h, w, 4), np.uint8)
        fr[..., :3] = (view * 255.0 + 0.5).astype(np.uint8)
        fr[..., 3] = 255
        out.append(fr)
    return out


def clip_through_video_path(frames: List[np.ndarray], path: str | None = None) -> List[np.ndarray]:
    """Round-trip RGBA frames through the port's Y4M writer and reader
    (4:2:0): the capture / video ingest path. Without `path` the file is a
    temporary one, removed afterwards."""
    h, w = frames[0].shape[:2]
    own = path is None
    if own:
        fd, path = tempfile.mkstemp(suffix=".y4m")
        os.close(fd)
    try:
        wtr = Y4MWriter(path, w, h, fps=30.0)
        for f in frames:
            wtr.write(f)
        wtr.close()
        reader = Y4MReader(path)
        try:
            return list(reader)
        finally:
            reader.close()
    finally:
        if own:
            os.unlink(path)


def _area_down(hr: np.ndarray, scale: int) -> np.ndarray:
    h, w = hr.shape[:2]
    v = hr.reshape(h // scale, scale, w // scale, scale, hr.shape[-1])
    return v.mean(axis=(1, 3))


class PairPool:
    """Pre-rendered pool of (lr, hr) RGB crop pairs in [0, 1] f32, on the
    host: `lrs` [pool_size, crop/scale, crop/scale, 3], `hrs` [pool_size,
    crop, crop, 3]. The clips go through the video path once; a batch is then
    an index draw."""

    def __init__(self, rng: np.random.Generator, scale: int = 2, crop: int = 96, n_clips: int = 12,
                 frames_per_clip: int = 6, pool_size: int = 4096, seed0: int = 100,
                 down_mix: float = 0.0) -> None:
        """`down_mix` > 0: that fraction of the clips (the first ones) is
        rendered at 2× (576×1024) and area-downsampled to 288×512, the way
        downscaled 4K footage differs from native 1080p."""
        self.scale, self.crop = scale, crop
        frames: List[np.ndarray] = []
        n_down = int(round(n_clips * down_mix))
        for c in range(n_clips):
            if c < n_down:
                hi = render_clip(h=576, w=1024, seed=seed0 + c, frames=frames_per_clip)
                clip = [np.concatenate([
                    np.clip(np.round(_area_down(f[..., :3].astype(np.float32), 2)), 0, 255).astype(np.uint8),
                    np.full((288, 512, 1), 255, np.uint8)], axis=-1) for f in hi]
            else:
                clip = render_clip(seed=seed0 + c, frames=frames_per_clip)
            frames.extend(clip_through_video_path(clip))
        hrs = np.empty((pool_size, crop, crop, 3), np.float32)
        lrs = np.empty((pool_size, crop // scale, crop // scale, 3), np.float32)
        for i in range(pool_size):
            f = frames[rng.integers(0, len(frames))]
            y = rng.integers(0, f.shape[0] - crop + 1)
            x = rng.integers(0, f.shape[1] - crop + 1)
            hr = f[y: y + crop, x: x + crop, :3].astype(np.float32) / 255.0
            hrs[i] = hr
            lrs[i] = _area_down(hr, scale)
        self.hrs, self.lrs = hrs, lrs

    def batch(self, rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
        idx = rng.integers(0, self.hrs.shape[0], size=n)
        return self.lrs[idx], self.hrs[idx]


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def eval_vs_lanczos3(apply_fn: Callable[[torch.Tensor], torch.Tensor], scale: int = 2,
                     seeds=EVAL_SEEDS, crop: int = 192, device=None) -> dict:
    """Held-out clips: PSNR / SSIM of the net against the lanczos3 tier on
    the same LR inputs. `apply_fn`: f32 RGB [1, h, w, 3] in [0, 1] on
    `device` → [1, h·scale, w·scale, 3] (a tensor or an array). The lanczos3
    reference is the port's `make_resampler` on `device`."""
    from nu_scaler_tpu_torch.ops.resample import make_resampler

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    net_p, net_s, lan_p, lan_s = [], [], [], []
    for seed in seeds:
        for f in clip_through_video_path(render_clip(seed=seed, frames=2)):
            y = rng.integers(0, f.shape[0] - crop + 1)
            x = rng.integers(0, f.shape[1] - crop + 1)
            hr_u8 = f[y: y + crop, x: x + crop]  # RGBA
            hr_rgb = hr_u8[..., :3]
            lr = _area_down(hr_u8[..., :3].astype(np.float32) / 255.0, scale)
            with torch.no_grad():
                out = apply_fn(torch.from_numpy(np.ascontiguousarray(lr[None])).to(dev))
            out = out.detach().float().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
            out_u8 = _u8(out[0])
            net_p.append(psnr(out_u8, hr_rgb))
            net_s.append(ssim(out_u8, hr_rgb))

            lr_u8 = np.empty(lr.shape[:2] + (4,), np.uint8)
            lr_u8[..., :3] = _u8(lr)
            lr_u8[..., 3] = 255
            up = make_resampler(lr.shape[0], lr.shape[1], crop, crop, "lanczos3", dev)
            lan = up(lr_u8).cpu().numpy()[..., :3]
            lan_p.append(psnr(lan, hr_rgb))
            lan_s.append(ssim(lan, hr_rgb))
    return {
        "net_psnr_db": float(np.mean(net_p)),
        "net_ssim": float(np.mean(net_s)),
        "lanczos3_psnr_db": float(np.mean(lan_p)),
        "lanczos3_ssim": float(np.mean(lan_s)),
        "psnr_delta_db": float(np.mean(net_p) - np.mean(lan_p)),
        "ssim_delta": float(np.mean(net_s) - np.mean(lan_s)),
    }


def held_out_mids(seeds, frames: int, height: int, width: int):
    """(a, b, the true mid) u8 RGBA triples of the held-out protocol: each
    clip's odd frames between their even neighbours, through the video
    path."""
    for seed in seeds:
        clip = clip_through_video_path(render_clip(height, width, frames=frames, seed=seed))
        for k in range(1, len(clip) - 1, 2):
            yield clip[k - 1], clip[k + 1], clip[k]


def eval_interp_refinement(seeds=(900, 901), frames: int = 5, height: int = 1080, width: int = 1920,
                           device=None) -> dict:
    """Held-out mid-frame quality of "flow_soft_ref" (the learned
    refinement) against "flow_soft" (the production soft warp), through the
    port's `make_interpolator` on `device`: PSNR / SSIM against the true
    middle frame."""
    from nu_scaler_tpu_torch.ops.interpolate import make_interpolator

    dev = resolve_device(device)
    soft_fn = make_interpolator(height, width, "flow_soft", dev)
    ref_fn = make_interpolator(height, width, "flow_soft_ref", dev)
    soft_p, soft_s, ref_p, ref_s = [], [], [], []
    for a, b, truth in held_out_mids(seeds, frames, height, width):
        at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        soft = soft_fn(at, bt, 0.5).cpu().numpy()
        ref = ref_fn(at, bt, 0.5).cpu().numpy()
        soft_p.append(psnr(soft, truth))
        soft_s.append(ssim(soft, truth))
        ref_p.append(psnr(ref, truth))
        ref_s.append(ssim(ref, truth))
    return {
        "soft_psnr_db": float(np.mean(soft_p)),
        "soft_ssim": float(np.mean(soft_s)),
        "ref_psnr_db": float(np.mean(ref_p)),
        "ref_ssim": float(np.mean(ref_s)),
        "psnr_delta_db": float(np.mean(ref_p) - np.mean(soft_p)),
        "ssim_delta": float(np.mean(ref_s) - np.mean(soft_s)),
    }
