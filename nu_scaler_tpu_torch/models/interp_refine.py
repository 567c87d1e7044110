"""The learned MC-interpolation refinement — the port of
`nu_scaler_tpu/models/interp_refine.py`, its serving paths and (at the end)
its training half: `TripletPool`, `train`, the named checkpoints under
`models/train.py`'s `CKPT_ROOT`, `calibrate_scales`, `eval_refine_float`. A small
phase-domain conv net that reads (A, B, the flow_soft mid) and predicts a
residual correction to the mid, the net of interpolation mode
"flow_soft_ref".

`InterpRefine` is the network as an `nn.Module` in the [0, 1] domain
(`InterpRefineTPU`, `:37-61`): a space-to-depth(4) front end, a head conv,
residual blocks (the learned tier's `ResBlock`) and a tail conv that emits
every phase's RGB residual, then depth-to-space. The mid-add lives in the
caller. `make_apply` is its fp32 twin (`:669`), `make_quant_apply` the fp32
twin of the int8 graph (`:686`).

`RefineGraph` is the raw-domain u8 serving graph of `get_refine_phase_graph`
and `get_refine_graph` (`:466-645`), with JAX's roundings in this order:

1. the head kernel is f32(kernel) / 255 in fp32, RGBA-expanded (zero alpha
   rows), then bf16; the tail kernel f32(kernel) · 255, then bf16; the tail
   bias ×255 stays fp32;
2. every conv rounds twice: its bf16 sum, then + the bf16 bias in bf16
   (`conv3x3(..., round_sum=True)`); the tail has no bias, so one rounding;
3. the residual h + bf16(0.2) · conv2(relu(conv1(h))) in bf16, the product
   and the sum each rounded;
4. the s2d channel of (row phase q, column phase p, frame f, RGBA c) is
   q·st·12 + p·12 + f·4 + c, the mid's own phases (q, p, c);
5. clip(round_half_even((f32(tail) + tail_b) + f32(mid phases)), 0, 255),
   then d2s, which is exact. Alpha comes through: the tail's alpha rows and
   bias are zero.

Its four convs run on the conv kernel (`kernels.conv_cuda.conv3x3`, the port
of the Pallas `make_conv3x3`; JAX runs them as XLA convs) at the kernel's
widths: the head's 192 s2d lanes zero-padded to 256, the tail's 64 outputs
to 128, which is exact. With int8 scales (a sidecar's ``act_scales`` at the
weights' step, or ``quant_scales``) the convs the scales name run on the int8
grid (`conv_cuda.conv3x3_q`, the counterpart of `_conv_i8`), as `mk_conv`
does (`:548-568`). The committed step has no calibration, so the bf16 graph
serves it.

The serving net's weights are the newest step the port's trainer saved under
`models/train.py` `CKPT_ROOT`/interp_ref4/ (`save_checkpoint`), else the
committed `nu_scaler_tpu_torch/weights/interp_ref4_{step}.npz` and its JSON
sidecar, written from the orbax checkpoint at the step its latest.txt names
by `tools/export_torch_weights.py`, as JAX serves the step its latest.txt
names; its int8 scales come only from the sidecar of those weights. The
wide distillation teacher interp_ref4w is committed the same way and never
serves. A missing npz, or one whose sha256 differs from its sidecar's,
raises: the port carries the weights, so their absence is a fault, not
JAX's fallback to plain flow_soft.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.kernels import conv_cuda
from nu_scaler_tpu_torch.models.esrgan_lite import (
    WEIGHTS_DIR,
    Conv3x3,
    ResBlock,
    _d2s,
    _quant_kernel_i8,
    _s2d,
    adam,
    amax,
    conv_f32,
    fp32_training,
    init_module,
    make_step,
    newest_sidecar,
    params_from_flax,
    read_weights,
    sidecar_scales,
    write_sidecar_scales,
    write_weights,
)

NET = "interp_ref4"  # the serving net; its wide teacher "interp_ref4w" never serves
FRAMES = 3  # a, b and the mid, concatenated on the channels
STRIDE = 4  # the serving net's s2d stride (InterpRefineTPU.stride)


class InterpRefine(nn.Module):
    """[N, H, W, 9] (A, B, mid RGB in [0, 1]) → residual [N, H, W, 3], in
    the parameters' dtype. Parameter names follow the flax module's
    (``head.kernel``, ``block0.conv1.bias``, ``tail.bias``)."""

    def __init__(self, features: int = 128, blocks: int = 1, stride: int = STRIDE) -> None:
        super().__init__()
        self.features, self.blocks, self.stride = features, blocks, stride
        self.head = Conv3x3(stride * stride * 3 * FRAMES, features)
        for i in range(blocks):
            self.add_module(f"block{i}", ResBlock(features))
        self.tail = Conv3x3(features, stride * stride * 3)

    def res_blocks(self) -> list[ResBlock]:
        return [getattr(self, f"block{i}") for i in range(self.blocks)]

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        h = self.head(_s2d(x01.to(self.head.kernel.dtype), self.stride))
        for blk in self.res_blocks():
            h = blk(h)
        return _d2s(self.tail(h), self.stride)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _newest(name: str = NET) -> Optional[tuple[dict, Path]]:
    """(sidecar, directory) of the newest weights of the net `name`: the
    newest step under `_ckpt_dir(name)` (the trainer's `CKPT_ROOT`, read at
    call time) when it holds one, else its committed export in `WEIGHTS_DIR`
    (interp_ref4 and its teacher interp_ref4w); None when neither does. The
    trainer saves at start + steps, so the newest step is the one JAX's
    ``latest.txt`` names."""
    for directory in (_ckpt_dir(name), WEIGHTS_DIR):
        meta = newest_sidecar(directory, f"{name}_*.json")
        if meta is not None:
            return meta, directory
    return None


def refine_available() -> bool:
    """True when weights of the serving net exist (`_newest`): the role of
    JAX's check for its latest.txt."""
    return _newest() is not None


def load_weights(name: str = NET) -> tuple[dict, dict]:
    """(nested flax-named numpy tree, sidecar metadata) of the newest weights
    of the net `name` (`_newest`). Raises FileNotFoundError without a
    sidecar or its npz, ValueError when the npz's sha256 is not its
    sidecar's: a corrupt checkpoint never gives way to the export."""
    found = _newest(name)
    if found is None:
        raise FileNotFoundError(f"no {name}_*.json sidecar under {_ckpt_dir(name)} or {WEIGHTS_DIR}")
    meta, directory = found
    return read_weights(directory / f"{name}_{meta['step']}.npz", meta["sha256"]), meta


def load_act_scales() -> Optional[dict]:
    """The int8 activation scales of the newest weights of the serving net
    (their sidecar's ``act_scales`` at their step), or None."""
    found = _newest()
    return None if found is None else sidecar_scales(found[0])


@functools.lru_cache(maxsize=1)
def load_model() -> tuple[InterpRefine, dict]:
    """The fp32 `InterpRefine` with the newest weights of the serving net,
    and their metadata. Cached: a process keeps serving what it loaded
    first, as JAX's cached graphs do; do not modify the module."""
    tree, meta = load_weights()
    model = InterpRefine(**meta["model"])
    model.load_state_dict(params_from_flax(tree))
    return model, meta


def make_apply(model: Optional[InterpRefine] = None) -> Callable[..., torch.Tensor]:
    """The fp32 float-domain forward (`make_apply`): (a, b, mid) f32 RGB
    [N, h, w, 3] in [0, 1] → mid + the residual, on the inputs' device."""
    model = model if model is not None else load_model()[0]

    def fn(a: torch.Tensor, b: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
        m = model.to(mid.device)
        return mid + m(torch.cat([a, b, mid], dim=-1).float())

    return fn


def make_quant_apply(model: InterpRefine, scales: dict) -> Callable[..., torch.Tensor]:
    """The fp32 twin of the int8 graph (`make_quant_apply`): the same
    integer weight grid and activation scales in the [0, 1] domain, every
    conv a scale names run as `_conv_i8` kept in fp32, the others in fp32.
    (a, b, mid) f32 RGB [N, h, w, 3] → mid + the residual."""

    def mk(conv: Conv3x3, ax: Optional[float]):
        k, b = conv.kernel.detach().float(), conv.bias.detach().float()
        if ax is None:
            return lambda x: conv_cuda.conv3x3_f32(x, k.to(x.device)) + b.to(x.device)
        kq, dq = _quant_kernel_i8(k.numpy())
        kq_t, scale = torch.from_numpy(kq.astype(np.float32)), conv_cuda.qgrid_scale(dq, float(ax))

        def conv_i8(x: torch.Tensor) -> torch.Tensor:
            xq = conv_cuda.quantize_act(x, float(ax), torch.float32)
            return conv_cuda.conv3x3_f32(xq, kq_t.to(x.device)) * scale.to(x.device) + b.to(x.device)

        return conv_i8

    head = mk(model.head, scales.get("head"))
    blocks = [(mk(blk.conv1, scales.get(f"block{i}/conv1")), mk(blk.conv2, scales.get(f"block{i}/conv2")))
              for i, blk in enumerate(model.res_blocks())]
    tail = mk(model.tail, scales.get("tail"))
    st = model.stride

    def fn(a: torch.Tensor, b: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
        h = head(_s2d(torch.cat([a, b, mid], dim=-1).float(), st))
        for c1, c2 in blocks:
            h = h + 0.2 * c2(torch.relu(c1(h)))
        return mid + _d2s(tail(h), st)

    return fn


# ---------------------------------------------------------------------------
# the raw-domain serving graph
# ---------------------------------------------------------------------------


def _expand_head(k: np.ndarray, st: int) -> np.ndarray:
    """HWIO head [3, 3, st²·9, F] (per pixel phase q: frame f, RGB) → [3, 3,
    st²·12, F] (per q: frame f, RGBA), alpha rows zero, each weight
    f32(k) / 255 in fp32 (`:494-504`)."""
    out = np.zeros(k.shape[:2] + (st * st * 4 * FRAMES, k.shape[3]), np.float32)
    for q in range(st * st):
        for f in range(FRAMES):
            out[:, :, q * 12 + f * 4: q * 12 + f * 4 + 3, :] = k[:, :, q * 9 + f * 3: q * 9 + f * 3 + 3, :] / 255.0
    return out


def _expand_tail(k: np.ndarray, b: np.ndarray, st: int) -> tuple[np.ndarray, np.ndarray]:
    """HWIO tail [3, 3, F, st²·3] and bias, each ×255 in fp32, → RGBA phases
    [3, 3, F, st²·4] and [st²·4] with zero alpha columns (`:518-528`)."""
    k, b = k * np.float32(255.0), b * np.float32(255.0)
    k4 = np.zeros(k.shape[:3] + (st * st * 4,), np.float32)
    b4 = np.zeros((st * st * 4,), np.float32)
    for q in range(st * st):
        k4[..., q * 4: q * 4 + 3] = k[..., q * 3: q * 3 + 3]
        b4[q * 4: q * 4 + 3] = b[q * 3: q * 3 + 3]
    return k4, b4


class RefineGraph:
    """The serving graph: u8 RGBA (a, b, mid) [H, W, 4] each → the refined
    mid, u8 RGBA [H, W, 4] (`__call__`), or its phases f32 [H/st, W/st,
    st²·4], integer-valued 0..255 (`phases_of`, `get_refine_phase_graph`).

    bf16 (no int8 scales): every conv through `conv` (`conv_cuda.conv3x3` by
    default; `conv_cuda.conv3x3_plain` runs the graph on its plain version).
    int8 (`quant_scales`): the convs the scales name ("head", "block{i}/conv1",
    "block{i}/conv2", "tail") on the int8 grid through `conv_q`
    (`conv_cuda.conv3x3_q` by default), the head's scale ×255 for the raw u8
    input; the others stay bf16."""

    def __init__(self, model: InterpRefine, in_h: int, in_w: int, device,
                 conv: Optional[Callable] = None, quant_scales: Optional[dict] = None,
                 conv_q: Optional[Callable] = None) -> None:
        st = model.stride
        if in_h % st or in_w % st:
            raise ValueError(f"{in_w}x{in_h} is not a multiple of the stride {st}")
        self.device = resolve_device(device)
        self.in_hw, self.stride = (in_h, in_w), st
        self.conv = conv or conv_cuda.conv3x3
        self.conv_q = conv_q or conv_cuda.conv3x3_q
        self.phases = st * st * 4

        def np32(t: torch.Tensor) -> np.ndarray:
            return t.detach().cpu().float().numpy()

        tail_k, tail_b = _expand_tail(np32(model.tail.kernel), np32(model.tail.bias), st)
        # every conv at the kernel's widths: (padded HWIO kernel, padded bias,
        # the int8 scale's name); the tail's bias is zero: it is added in fp32
        layers = [(*conv_cuda.pad_weights(_expand_head(np32(model.head.kernel), st), np32(model.head.bias)),
                   "head")]
        for i, blk in enumerate(model.res_blocks()):
            layers += [(*conv_cuda.pad_weights(np32(c.kernel), np32(c.bias)), f"block{i}/{name}")
                       for name, c in (("conv1", blk.conv1), ("conv2", blk.conv2))]
        layers.append((*conv_cuda.pad_weights(tail_k, np.zeros_like(tail_b)), "tail"))
        self.head_lanes = layers[0][0].shape[2]
        self.tail_b = torch.from_numpy(tail_b).to(self.device)
        self.quant_scales = quant_scales
        q = quant_scales or {}

        def bf16(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device).to(torch.bfloat16)

        def bias(b: np.ndarray, name: str):
            # the int8 grid's fp32 bias; the tail has none in JAX's graph
            return None if name == "tail" else torch.from_numpy(b).to(self.device)

        # per layer: ("bf16", k, b) or ("int8", kq, scale, fp32 bias or None, ax)
        self.layers = []
        for k, b, name in layers:
            if name not in q:
                self.layers.append(("bf16", bf16(k), bf16(b)))
                continue
            ax = (255.0 if name == "head" else 1.0) * float(q[name])
            kq, dq = _quant_kernel_i8(k)  # a padded row or column is zero: kq 0
            self.layers.append(("int8", bf16(kq.astype(np.float32)),
                                conv_cuda.qgrid_scale(dq, ax).to(self.device), bias(b, name), ax))

    @property
    def quantized(self) -> bool:
        return bool(self.quant_scales)

    @property
    def convs_per_frame(self) -> int:
        """Conv launches per refined mid (either mode)."""
        return len(self.layers)

    def _conv(self, layer: tuple, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        if layer[0] == "bf16":
            return self.conv(x, layer[1], layer[2], relu, True)
        _, kq, scale, b, ax = layer
        return self.conv_q(conv_cuda.quantize_act(x, ax), kq, scale, b, relu)

    def _check(self, *frames: torch.Tensor) -> None:
        for x in frames:
            if tuple(x.shape) != (*self.in_hw, 4) or x.dtype != torch.uint8:
                raise ValueError(f"expected u8 [{self.in_hw[0]}, {self.in_hw[1]}, 4], "
                                 f"got {x.dtype} {tuple(x.shape)}")

    def phases_of(self, a: torch.Tensor, b: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
        """The refined mid's phases: f32 [H/st, W/st, st²·4], integer-valued
        0..255, channel (row phase, column phase, RGBA)."""
        self._check(a, b, mid)
        st = self.stride
        a, b, mid = (x.to(self.device) for x in (a, b, mid))
        # raw 0..255 values, exact in bf16; channel q·st·12 + p·12 + f·4 + c
        s2d = _s2d(torch.cat([a, b, mid], dim=-1)[None], st).to(torch.bfloat16)
        head, *blocks, tail = self.layers
        h = self._conv(head, conv_cuda.pad_lanes(s2d, self.head_lanes))
        c02 = torch.tensor(0.2, dtype=torch.bfloat16, device=h.device)  # bf16(0.2), as JAX's
        for c1, c2 in zip(blocks[::2], blocks[1::2]):
            h = h + c02 * self._conv(c2, self._conv(c1, h, relu=True))
        res = self._conv(tail, h)[0, ..., : self.phases].float()
        mid_ph = _s2d(mid[None], st)[0].float()
        return torch.clamp(torch.round(res + self.tail_b + mid_ph), 0, 255)

    def __call__(self, a: torch.Tensor, b: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
        """The refined mid, u8 RGBA [H, W, 4]: the phases, then d2s."""
        return _d2s(self.phases_of(a, b, mid).to(torch.uint8)[None], self.stride)[0]


@functools.lru_cache(maxsize=16)
def _refine_graph(in_h: int, in_w: int, dev: torch.device) -> RefineGraph:
    model, meta = load_model()
    return RefineGraph(model, in_h, in_w, dev, quant_scales=sidecar_scales(meta))


def get_refine_graph(in_h: int, in_w: int, device=None) -> RefineGraph:
    """The serving graph of the serving net (`load_model`: the newest step in
    the trainer's `CKPT_ROOT`, else the committed one) at this frame size on
    `device` (the card unless "cpu"), int8 where the sidecar of those
    weights carries scales at their step; cached. Raises when the weights
    are missing or corrupt, or the size is not a multiple of the stride."""
    return _refine_graph(in_h, in_w, resolve_device(device))


def refine_mid(a_u8: torch.Tensor, b_u8: torch.Tensor, mid_u8: torch.Tensor, device=None) -> torch.Tensor:
    """Refine a soft-warp mid (u8 RGBA [H, W, 4]) on `device`; a frame whose
    sides the stride does not divide returns the mid unchanged, as JAX's
    `refine_mid` does."""
    h, w = int(mid_u8.shape[0]), int(mid_u8.shape[1])
    if h % STRIDE or w % STRIDE:
        return mid_u8
    return get_refine_graph(h, w, device)(a_u8, b_u8, mid_u8)


# ---------------------------------------------------------------------------
# training (`interp_refine.py:64-390`)
# ---------------------------------------------------------------------------


def make_model(features: int = 128, blocks: int = 1, seed: int = 0) -> InterpRefine:
    """A fresh fp32 `InterpRefine` on the CPU, initialised with flax's
    distributions by `esrgan_lite.init_module(·, seed)` (JAX's `make_model`
    inits with `PRNGKey(0)`; its values cannot be reproduced)."""
    return init_module(InterpRefine(features=features, blocks=blocks), seed)


def _ckpt_dir(name: str = NET) -> Path:
    """The checkpoints of the net `name`: `train.CKPT_ROOT`/<name>/, beside
    the SR tier's (`interp_refine.py:73`). Serving reads the newest step of
    the serving net here before the committed one (`_newest`); other names
    (the teacher interp_ref4w) never serve."""
    from nu_scaler_tpu_torch.models import train

    return Path(train.CKPT_ROOT) / name


def save_checkpoint(model: InterpRefine, step: int, name: str = NET) -> Path:
    """`_ckpt_dir(name)`/{name}_{step}.npz and its sidecar (the committed
    weights' format: net, model kwargs, step, sha256). Returns the npz."""
    meta = {"net": name, "model": dict(features=model.features, blocks=model.blocks, stride=model.stride),
            "step": step}
    return write_weights(_ckpt_dir(name) / f"{name}_{step}", model, meta)


def load_checkpoint(name: str = NET) -> Optional[tuple[InterpRefine, int]]:
    """(fp32 module, step) of the newest weights of `name` (`_newest`: under
    `_ckpt_dir(name)`, else its committed export), or None. A fresh module:
    the cached `load_model` one is never modified."""
    if _newest(name) is None:
        return None
    tree, meta = load_weights(name)
    model = InterpRefine(**meta["model"])
    model.load_state_dict(params_from_flax(tree))
    return model, int(meta["step"])


def save_act_scales(scales: dict, step: int, name: str = NET) -> Path:
    """Record the int8 activation scales in the sidecar of the checkpoint
    `name` at `step` (step-gated, as `sidecar_scales` reads them)."""
    return write_sidecar_scales(_ckpt_dir(name) / f"{name}_{step}.json", scales)


class TripletPool:
    """Pre-rendered (A, B, production mid, target) crop pool: `xs` f32
    [pool_size, crop, crop, 9] (A, B, mid RGB in [0, 1]) and `ys` f32
    [pool_size, crop, crop, 3] (the true frame), on the host.

    The clips render at the serving size (1080p by default) through the
    video path; the mids come from the production soft warp on the full
    frame (`ops.interpolate.soft_interp_fast`, the `soft_warp_blend` kernel
    on the card), then are cropped, so the net trains on the artefacts it
    must fix when it serves. Training seeds 100.. stay disjoint from the
    900+ eval seeds. `factors`: frame-rate factors (2: t = 0.5; 3 adds pairs
    three frames apart at t = 1/3, 2/3). `sources`, round-robin per clip:
    "native" renders at (height, width), "down4k" at twice that, then the
    port's "area" `make_resampler` on `device`. The draws from `rng` (crop
    triplet, y, x per entry) follow JAX's order (`interp_refine.py:198`)."""

    def __init__(self, rng: np.random.Generator, crop: int = 96, n_clips: int = 12, frames_per_clip: int = 8,
                 pool_size: int = 4096, seed0: int = 100, height: int = 1080, width: int = 1920,
                 factors: tuple = (2,), sources: tuple = ("native",), device=None) -> None:
        from nu_scaler_tpu_torch.models.data import clip_through_video_path, render_clip
        from nu_scaler_tpu_torch.ops.interpolate import soft_interp_fast
        from nu_scaler_tpu_torch.ops.resample import make_resampler

        dev = resolve_device(device)
        triplets = []  # (A, B, mid, target) full frames, u8 RGBA
        for c in range(n_clips):
            if sources[c % len(sources)] == "down4k":
                down = make_resampler(2 * height, 2 * width, height, width, "area", dev)
                big = render_clip(2 * height, 2 * width, seed=seed0 + c, frames=frames_per_clip)
                clip = clip_through_video_path([down(f).cpu().numpy() for f in big])
            else:
                clip = clip_through_video_path(render_clip(height, width, seed=seed0 + c, frames=frames_per_clip))
            for f in factors:
                # stride 1: overlapping pairs
                for k in range(0, len(clip) - f):
                    a, b = clip[k], clip[k + f]
                    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
                    for j in range(1, f):
                        mid = soft_interp_fast(at, bt, j / f).cpu().numpy()
                        triplets.append((a, b, mid, clip[k + j]))
        xs = np.empty((pool_size, crop, crop, 9), np.float32)
        ys = np.empty((pool_size, crop, crop, 3), np.float32)
        for i in range(pool_size):
            a, b, mid, tgt = triplets[rng.integers(0, len(triplets))]
            y = rng.integers(0, a.shape[0] - crop + 1)
            x = rng.integers(0, a.shape[1] - crop + 1)
            sl = np.s_[y: y + crop, x: x + crop, :3]
            xs[i] = np.concatenate([a[sl], b[sl], mid[sl]], axis=-1).astype(np.float32) / 255.0
            ys[i] = tgt[sl].astype(np.float32) / 255.0
        self.xs, self.ys = xs, ys


def refine_loss(model: InterpRefine, xb: torch.Tensor, yb: torch.Tensor,
                teacher: Optional[InterpRefine] = None, distill_w: float = 0.5) -> torch.Tensor:
    """The refinement step's loss (`interp_refine.py:350-358`): mean |mid +
    net(A, B, mid) − target|, plus with a frozen `teacher` distill_w · mean
    |pred − (mid + teacher(A, B, mid))|, the teacher out of the graph."""
    mid = xb[..., 6:9]
    pred = mid + model(xb)
    loss = torch.mean(torch.abs(pred - yb))
    if teacher is not None:
        with torch.no_grad():
            t_pred = mid + teacher(xb)
        loss = loss + distill_w * torch.mean(torch.abs(pred - t_pred))
    return loss


def train(steps: int = 8000, batch: int = 8, lr: float = 2e-4, seed: int = 0, crop: int = 96, n_clips: int = 12,
          pool_size: int = 4096, log_every: int = 100, save: bool = True, height: int = 1080, width: int = 1920,
          factors: tuple = (2,), sources: tuple = ("native",), features: int = 128, blocks: int = 1,
          name: str = NET, distill: Optional[tuple] = None, distill_w: float = 0.5, device=None,
          frames_per_clip: int = 8) -> float:
    """One training leg of the refinement net `name` on `device` (the card
    unless "cpu"); returns the final loss. Resumes from `load_checkpoint(name)`
    (the newest under `_ckpt_dir(name)`, else the committed export), else a fresh
    `make_model(features, blocks)`; `distill` = (teacher name, features,
    blocks) adds distill_w·|student − frozen teacher|. The pool
    (`TripletPool`) moves to the device once and each step takes only its
    indices, drawn from the same generator after the pool's crops
    (`frames_per_clip`, JAX's fixed 8, may cut the pool's depth). Saves at
    start + steps under `_ckpt_dir(name)`; no optimizer state is kept, as
    JAX keeps none for this net."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    start = 0
    restored = load_checkpoint(name)
    model = make_model(features, blocks)
    if restored is not None:
        model.load_state_dict(restored[0].state_dict())
        start = restored[1]
        print(f"resumed {name} from step {start}", flush=True)
    model.to(dev)

    teacher = None
    if distill is not None:
        t_name, t_features, t_blocks = distill
        t_restored = load_checkpoint(t_name)
        if t_restored is None:
            raise ValueError(f"no teacher checkpoint {t_name!r}")
        teacher = t_restored[0].to(dev)
        if (teacher.features, teacher.blocks) != (int(t_features), int(t_blocks)):
            raise ValueError(f"teacher {t_name!r} is {teacher.features}/{teacher.blocks}, "
                             f"not {t_features}/{t_blocks}")
        print(f"distilling from {t_name}@{t_restored[1]} (w={distill_w})", flush=True)

    opt = adam(model, lr)
    step_fn = make_step(model, opt, lambda xb, yb: refine_loss(model, xb, yb, teacher, distill_w))

    print("rendering triplet pool (production soft-warp mids)...", flush=True)
    pool = TripletPool(rng, crop=crop, n_clips=n_clips, frames_per_clip=frames_per_clip, pool_size=pool_size,
                       height=height, width=width, factors=factors, sources=sources, device=dev)
    pool_x, pool_y = torch.from_numpy(pool.xs).to(dev), torch.from_numpy(pool.ys).to(dev)

    loss = torch.tensor(float("nan"))
    t0 = time.time()
    for s in range(steps):
        idx = torch.from_numpy(rng.integers(0, pool.xs.shape[0], size=batch)).to(dev)
        model, opt, loss = step_fn(pool_x[idx], pool_y[idx])
        if s % log_every == 0:
            print(f"step {s:5d}  loss {float(loss):.5f}  ({time.time() - t0:.1f}s)", flush=True)
    print(f"final loss {float(loss):.5f}", flush=True)
    if save:
        print(f"checkpoint: {save_checkpoint(model, start + steps, name)}", flush=True)
    return float(loss)


def calibrate_scales(model: Optional[InterpRefine] = None, crops=None, n_clips: int = 4, pool_size: int = 256,
                     height: int = 1080, width: int = 1920, include_head: bool = True, device=None) -> dict:
    """Per-conv-input activation maxima of the int8 graph (`interp_refine.py:138`),
    in the [0, 1] domain of the fp32 forward, on `device`: on `crops` [N, h,
    w, 9], else on a `TripletPool` of the training seeds drawn with
    `default_rng(7)`. `model` defaults to `load_checkpoint()`. Returns {"head"
    (with `include_head`), "block{i}/conv1", "block{i}/conv2", "tail"}."""
    dev = resolve_device(device)
    if model is None:
        restored = load_checkpoint()
        if restored is None:
            raise ValueError(f"no {NET} checkpoint")
        model = restored[0]
    if crops is None:
        crops = TripletPool(np.random.default_rng(7), crop=96, n_clips=n_clips, pool_size=pool_size,
                            height=height, width=width, device=dev).xs
    x = torch.as_tensor(crops, dtype=torch.float32, device=dev)
    scales: dict = {}
    with torch.no_grad():
        s2d = _s2d(x, model.stride)
        if include_head:
            scales["head"] = amax(s2d)
        h = conv_f32(s2d, model.head)
        for i, blk in enumerate(model.res_blocks()):
            scales[f"block{i}/conv1"] = amax(h)
            t1 = torch.relu(conv_f32(h, blk.conv1))
            scales[f"block{i}/conv2"] = amax(t1)
            h = h + 0.2 * conv_f32(t1, blk.conv2)
        scales["tail"] = amax(h)
    return scales


def eval_refine_float(name: str = NET, features: int = 128, blocks: int = 1, seeds=(900, 901, 902),
                      frames: int = 5, height: int = 1080, width: int = 1920, device=None) -> dict:
    """Held-out mid-frame quality of the named net (`load_checkpoint(name)`)
    through its fp32 forward (mid + net(A, B, mid), rounded to u8) against
    the production soft warp (`interp_refine.py:389`), on `device`: odd
    frames from their even neighbours, seeds 900+."""
    from nu_scaler_tpu_torch.models.data import held_out_mids
    from nu_scaler_tpu_torch.ops.interpolate import make_interpolator
    from nu_scaler_tpu_torch.ops.metrics import psnr, ssim

    dev = resolve_device(device)
    restored = load_checkpoint(name)
    if restored is None:
        raise ValueError(f"no checkpoint {name!r}")
    model, step = restored
    if (model.features, model.blocks) != (features, blocks):
        raise ValueError(f"{name!r} is {model.features}/{model.blocks}, not {features}/{blocks}")
    model.to(dev)
    apply_fn = make_apply(model)
    soft_fn = make_interpolator(height, width, "flow_soft", dev)
    soft_p, soft_s, ref_p, ref_s = [], [], [], []
    for a, b, truth in held_out_mids(seeds, frames, height, width):
        at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        soft_t = soft_fn(at, bt, 0.5)
        x01 = [t[None, ..., :3].float() / 255.0 for t in (at, bt, soft_t)]
        with torch.no_grad(), fp32_training():
            pred = apply_fn(*x01)[0]
        soft = soft_t.cpu().numpy()
        refined = np.dstack([torch.clamp(torch.round(pred * 255.0), 0, 255).to(torch.uint8).cpu().numpy(),
                             soft[..., 3:]])
        soft_p.append(psnr(soft, truth))
        soft_s.append(ssim(soft, truth))
        ref_p.append(psnr(refined, truth))
        ref_s.append(ssim(refined, truth))
    out = {
        "name": name, "step": step,
        "soft_psnr_db": float(np.mean(soft_p)), "soft_ssim": float(np.mean(soft_s)),
        "ref_psnr_db": float(np.mean(ref_p)), "ref_ssim": float(np.mean(ref_s)),
        "psnr_delta_db": float(np.mean(ref_p) - np.mean(soft_p)),
        "ssim_delta": float(np.mean(ref_s) - np.mean(soft_s)),
    }
    print(f"{name}@{step}: {out['ref_psnr_db']:.2f} dB / {out['ref_ssim']:.4f} SSIM vs soft "
          f"{out['soft_psnr_db']:.2f} / {out['soft_ssim']:.4f} (Δ {out['psnr_delta_db']:+.2f} dB / "
          f"{out['ssim_delta']:+.4f})", flush=True)
    return out
