"""ESRGAN-lite, the learned "ultra" tier — the port of
`nu_scaler_tpu/models/esrgan_lite.py` (its bf16 serving path).

`ESRGANLiteTPU` is the network as an `nn.Module` in the [0, 1] domain: a
space-to-depth(stride) front end, a head conv, residual blocks
(conv → ReLU → conv, 0.2-scaled skip), a trunk conv with the global skip, a
tail conv that emits every output phase, and a fixed bilinear base over the
s2d neighbourhood added back. Its convs follow flax `nn.Conv` in the module's
dtype: the sum in fp32, rounded to the dtype, then the bias added in the
dtype. In fp32 it is the twin the JAX package's fidelity gate compares the
served bytes with (`bench.py` `_twin_model_fn`: f32 parameters on f32
input).

`make_serving_fn_fused` is the production serving graph for exact ratios
(`esrgan_lite.py:891` in its bf16 branch): u8 RGBA in, u8 RGBA out, in the
raw 0..255 domain (1/255 folded into the head kernel, 255 into the tail),
with alpha riding the bilinear base. Its seven (x2, tpu4b2) or nine (x4,
tpu4) 3×3 convs go through `kernels.conv_cuda.conv3x3`, the port of the
Pallas `make_conv3x3`, with ``round_sum=True``: the JAX graph's XLA conv
rounds its sum to bf16 before the bias is added in bf16, and the kernel's
epilogue does the same. With ``trunk_impl="fused"`` the whole chain, head to
tail, is one launch of `kernels.trunk_cuda.trunk_fused`, the port of the
Pallas `make_trunk_fused`, with the same rounding (the counterpart of the
JAX model's `conv_impl` switch); "layers" stays the default. The fixed base
is an fp32 VALID conv, exact in any order. Every other cast to bf16 sits
where the JAX graph puts it.

With ``quant_scales`` (a checkpoint's int8 calibration) the graph is the
int8 branch of `make_serving_fn_fused` (`esrgan_lite.py:950-1076`) that the
"quality" (default) and "performance" ladders serve: every residual-block,
trunk and tail conv is `_conv_i8` — the activation quantised by
`conv_cuda.quantize_act`, then `conv_cuda.conv3x3_q`, the conv kernel's
int8-grid epilogue — and, with "head" / "base" scales, the head and the
fixed base too (the base VALID on the edge-padded 128-lane input: the
kernel runs it SAME over the padded tensor and the interior is kept).
`make_quant_apply` is its fp32 twin, the one the bench's gates compare with.

Weights and int8 scales come from the files under
`nu_scaler_tpu_torch/weights/`, written from the orbax checkpoints and their
``act_scales.json`` by `tools/export_torch_weights.py`. The stride-2 and
stride-8 archs and the non-exact-ratio path raise `NotImplementedError`
with their ROADMAP item.
"""

from __future__ import annotations

import functools
import hashlib
import json
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.kernels import conv_cuda, trunk_cuda
from nu_scaler_tpu_torch.ops.resample import to_device_u8

WEIGHTS_DIR = Path(__file__).resolve().parents[1] / "weights"

# The port's copy of `_ARCH_LADDER` (esrgan_lite.py:547-589): (arch, model
# kwargs, mode). Mode "quant" serves only when the checkpoint's int8 scales
# match its step; "ultra" serves bf16, the other ladders serve int8 whenever
# the served checkpoint has matching scales.
ARCH_LADDER = {
    "ultra": (
        ("tpu4b2", dict(stride=4, features=128, blocks=2), None),
        ("tpu4", dict(stride=4, features=128), None),
        ("tpu", {}, None),
    ),
    "quality": (
        ("tpu4b2", dict(stride=4, features=128, blocks=2), "quant"),
        ("tpu4", dict(stride=4, features=128), "quant"),
        ("tpu4b2", dict(stride=4, features=128, blocks=2), None),
        ("tpu4", dict(stride=4, features=128), None),
        ("tpu", {}, None),
    ),
    "performance": (
        ("tpu4b1", dict(stride=4, features=128, blocks=1), None),
        ("tpu8w", dict(stride=8, features=192), None),
        ("tpu8", dict(stride=8, features=128), None),
        ("tpu4b2", dict(stride=4, features=128, blocks=2), None),
        ("tpu4", dict(stride=4, features=128), None),
        ("tpu", {}, None),
    ),
}
NOT_PORTED_ARCH = "is not ported yet (ROADMAP queue 1, item 9)"


# ---------------------------------------------------------------------------
# the port's copies of the JAX module's numpy helpers
# ---------------------------------------------------------------------------


def scale_to_stages(in_h: int, out_h: int) -> int:
    ratio = out_h / in_h
    return max(1, int(round(np.log2(max(ratio, 2.0)))))


@functools.lru_cache(maxsize=8)
def _bilinear_base_kernel(c: int, upscale: int, stride: int = 2) -> np.ndarray:
    """Fixed HWIO 3×3 kernel turning the s2d(`stride`) tensor into the
    phase-domain bilinear upscale of the original image (half-pixel-centre
    alignment): output phase (py, px) of a trunk cell samples input
    coordinate stride·I + (p + 0.5)/upscale − 0.5, whose two bilinear taps
    per axis lie in the 3×3 s2d neighbourhood."""
    s = stride
    r = s * upscale
    k = np.zeros((3, 3, s * s * c, r * r * c), np.float32)
    for py in range(r):
        dy = (py + 0.5) / upscale - 0.5
        m0 = int(np.floor(dy))
        fy = dy - m0
        for px in range(r):
            dx = (px + 0.5) / upscale - 0.5
            n0 = int(np.floor(dx))
            fx = dx - n0
            for m, wy in ((m0, 1.0 - fy), (m0 + 1, fy)):
                for nn_, wx in ((n0, 1.0 - fx), (n0 + 1, fx)):
                    diy, qy = m // s, m % s
                    dix, qx = nn_ // s, nn_ % s
                    for ch in range(c):
                        k[diy + 1, dix + 1, qy * s * c + qx * c + ch, py * r * c + px * c + ch] += wy * wx
    return k


def _expand_in_rgba(k: np.ndarray, st: int, scale: float) -> np.ndarray:
    """HWIO kernel with I = st²·3 (RGB s2d rows) → I' = st²·4 (RGBA s2d),
    alpha rows zero, weights scaled by `scale`."""
    kh, kw, _i3, o = k.shape
    out = np.zeros((kh, kw, st * st * 4, o), np.float32)
    for q in range(st * st):
        out[:, :, q * 4 : q * 4 + 3, :] = k[:, :, q * 3 : q * 3 + 3, :] * scale
    return out


def _expand_out_rgba(k: np.ndarray, b: np.ndarray, r: int, scale: float):
    """HWIO kernel with O = r²·3 phase-major RGB → O' = r²·4 RGBA-interleaved
    (alpha outputs zero), scaled by `scale`."""
    kh, kw, i, _o3 = k.shape
    out = np.zeros((kh, kw, i, r * r * 4), np.float32)
    ob = np.zeros((r * r * 4,), np.float32)
    for ph in range(r * r):
        out[:, :, :, ph * 4 : ph * 4 + 3] = k[:, :, :, ph * 3 : ph * 3 + 3] * scale
        ob[ph * 4 : ph * 4 + 3] = b[ph * 3 : ph * 3 + 3] * scale
    return out, ob


def _quant_kernel_i8(k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """HWIO f32 kernel → (int8 kernel, per-output-channel f32 dequant scale):
    kq[..., o] = round(k[..., o] / s_o), s_o = max|k[..., o]| / 127 (1 for an
    all-zero channel, whose kq is 0)."""
    amax = np.max(np.abs(k), axis=(0, 1, 2))
    s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    kq = np.clip(np.round(k / s), -127, 127).astype(np.int8)
    return kq, s


def _quant_kernel_i8_dc(k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`_quant_kernel_i8` with each channel's scale renormalised so the
    quantised taps sum to the original tap sum (flat fields, the α ≡ 255
    plane included, pass the fixed base exactly)."""
    kq, s = _quant_kernel_i8(k)
    qsum = kq.astype(np.float64).sum(axis=(0, 1, 2))
    osum = k.astype(np.float64).sum(axis=(0, 1, 2))
    s = np.where(qsum != 0, osum / np.where(qsum == 0, 1, qsum), s).astype(np.float32)
    return kq, s


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def _s2d(x: torch.Tensor, st: int) -> torch.Tensor:
    """[N, H, W, C] → [N, H/st, W/st, st²·C], channel qy·st·C + qx·C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // st, st, w // st, st, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // st, w // st, st * st * c)


def _d2s(ph: torch.Tensor, r: int) -> torch.Tensor:
    """[N, h, w, r²·C] phases (channel py·r·C + px·C + c) → [N, r·h, r·w, C]."""
    n, h, w, rrc = ph.shape
    c = rrc // (r * r)
    x = ph.reshape(n, h, w, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c)


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] → [N, H + 2, W + 2, C], the border repeated."""
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)


class Conv3x3(nn.Module):
    """flax `nn.Conv(features, (3, 3), padding="SAME")`: HWIO `kernel`,
    `bias`; in the parameters' dtype the sum (fp32) is rounded to the dtype
    and the bias added in the dtype."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_cuda.conv3x3_f32(x, self.kernel).to(self.bias.dtype) + self.bias


class ResBlock(nn.Module):
    def __init__(self, features: int) -> None:
        super().__init__()
        self.conv1 = Conv3x3(features, features)
        self.conv2 = Conv3x3(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(torch.relu(self.conv1(x)))
        # 0.2 in the dtype, as JAX's weakly typed scalar is
        return x + torch.tensor(0.2, dtype=h.dtype, device=h.device) * h


class ESRGANLiteTPU(nn.Module):
    """The s2d / phase-domain ESRGAN-lite (`esrgan_lite.py:248`). Parameter
    names follow the flax module's (``head.kernel``, ``block0.conv1.bias``,
    …); `params_from_flax` maps a flax tree onto them."""

    def __init__(self, features: int = 64, blocks: int = 3, upscale: int = 2,
                 stride: int = 2) -> None:
        super().__init__()
        self.features, self.blocks, self.upscale, self.stride = features, blocks, upscale, stride
        r = stride * upscale
        self.head = Conv3x3(stride * stride * 3, features)  # RGB
        for i in range(blocks):
            self.add_module(f"block{i}", ResBlock(features))
        self.trunk = Conv3x3(features, features)
        self.tail = Conv3x3(features, r * r * 3)

    def res_blocks(self) -> list[ResBlock]:
        return [getattr(self, f"block{i}") for i in range(self.blocks)]

    def forward(self, x01: torch.Tensor, phase_domain: bool = False) -> torch.Tensor:
        """x01: [N, H, W, 3] in [0, 1] → [N, uH, uW, 3] (or the phase tensor
        [N, H/st, W/st, r²·3]), in the parameters' dtype."""
        dt = self.head.kernel.dtype
        st, r = self.stride, self.stride * self.upscale
        s2d = _s2d(x01.to(dt), st)
        feat = self.head(s2d)
        h = feat
        for blk in self.res_blocks():
            h = blk(h)
        h = self.trunk(h) + feat
        tail = self.tail(h)
        base_k = torch.from_numpy(_bilinear_base_kernel(x01.shape[-1], self.upscale, st))
        base = conv_cuda.conv_valid_f32(_edge_pad(s2d), base_k.to(dt).to(s2d.device)).to(dt)
        phases = tail + base
        return phases if phase_domain else _d2s(phases, r)


def params_from_flax(tree) -> dict:
    """A flax parameter tree (nested mappings of arrays under flax names,
    with or without the top "params" level) → the module's state dict
    (fp32 tensors)."""
    if "params" in tree:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if hasattr(val, "items"):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = torch.from_numpy(np.array(val, np.float32))

    walk(tree, "")
    return out


def _sidecar(arch: str, upscale: int) -> Optional[dict]:
    """The JSON sidecar of the newest committed weights of `arch` at
    `upscale`, or None."""
    sidecars = sorted(WEIGHTS_DIR.glob(f"esrgan_{arch}_x{upscale}_*.json"))
    if not sidecars:
        return None
    return max((json.loads(p.read_text()) for p in sidecars), key=lambda m: m["step"])


def load_weights(arch: str, upscale: int) -> Optional[tuple[dict, dict]]:
    """(nested flax-named numpy tree, sidecar metadata) of the committed
    weights of `arch` at `upscale`, or None when the port carries none. The
    npz's sha256 must match its sidecar's."""
    meta = _sidecar(arch, upscale)
    if meta is None:
        return None
    npz = WEIGHTS_DIR / f"esrgan_{arch}_x{upscale}_{meta['step']}.npz"
    digest = hashlib.sha256(npz.read_bytes()).hexdigest()
    if digest != meta["sha256"]:
        raise ValueError(f"{npz.name}: sha256 {digest} != its sidecar's {meta['sha256']}")
    tree: dict = {}
    with np.load(npz) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree, meta


def load_act_scales(arch: str, upscale: int) -> Optional[dict]:
    """The int8 activation scales of the committed weights of `arch` at
    `upscale` (their sidecar's ``act_scales``), or None when the port carries
    none or they were calibrated at another step than the weights'
    (`nu_scaler_tpu/models/train.py` `load_act_scales`)."""
    meta = _sidecar(arch, upscale)
    blob = meta and meta.get("act_scales")
    if not blob or blob.get("step") != meta["step"]:
        return None
    scales = blob.get("scales")
    return dict(scales) if isinstance(scales, dict) and scales else None


def load_model(arch: str, upscale: int) -> Optional[tuple[ESRGANLiteTPU, dict]]:
    """The fp32 module with the committed weights of `arch` at `upscale`,
    and its metadata; None when the port carries no such weights."""
    loaded = load_weights(arch, upscale)
    if loaded is None:
        return None
    tree, meta = loaded
    model = ESRGANLiteTPU(upscale=upscale, **meta["model"])
    model.load_state_dict(params_from_flax(tree))
    return model, meta


# ---------------------------------------------------------------------------
# the serving graph
# ---------------------------------------------------------------------------

ConvFn = Callable[..., torch.Tensor]  # (x, k, b, relu, round_sum) → bf16
ConvQFn = Callable[..., torch.Tensor]  # (xq, kq, scale, b, relu) → bf16
TRUNK_IMPLS = ("layers", "fused")


class QConv(NamedTuple):
    """One conv on the int8 grid (`_conv_i8`'s operands): the int8 kernel as
    integer-valued bf16 HWIO, the fp32 dequantisation f32(dq)·f32(ax/127)
    per output channel, the fp32 bias (or None) and the activation scale."""

    kq: torch.Tensor
    scale: torch.Tensor
    b: Optional[torch.Tensor]
    ax: float


class FusedServing:
    """The raw-domain serving graph of `make_serving_fn_fused`: u8 RGBA
    [N, H, W, 4] → u8 RGBA [N, uH, uW, 4] for the whole batch.

    bf16 (``quant_scales`` None): `trunk_impl` "layers" runs the learned
    layers as one conv launch each, with `conv` (the kernel wrapper by
    default; `conv_cuda.conv3x3_plain` to run the graph on its plain
    version); "fused" runs them as one launch of the fused trunk kernel.

    int8 (``quant_scales``, a checkpoint's calibration): the blocks, trunk and
    tail — and the head and the fixed base where the scales name them — run
    on the int8 grid through `conv_q` (`conv_cuda.conv3x3_q` by default;
    `conv_cuda.conv3x3_q_plain` for the plain version); a missing "head" /
    "base" leaves the bf16 head and the fp32 base. The fused trunk is bf16
    only, as JAX's is."""

    def __init__(self, model: ESRGANLiteTPU, in_h: int, in_w: int, device,
                 conv: Optional[ConvFn] = None, trunk_impl: str = "layers",
                 quant_scales: Optional[dict] = None, conv_q: Optional[ConvQFn] = None) -> None:
        if trunk_impl not in TRUNK_IMPLS:
            raise ValueError(f"trunk_impl must be one of {TRUNK_IMPLS}, got {trunk_impl!r}")
        if quant_scales is not None and trunk_impl != "layers":
            raise ValueError("trunk_impl='fused' serves bf16 only: the int8 ladders run "
                             "trunk_impl='layers'")
        st, up = model.stride, model.upscale
        if in_h % st or in_w % st:
            raise ValueError(f"{in_w}x{in_h} is not a multiple of the stride {st}")
        self.device = resolve_device(device)
        self.in_hw = (in_h, in_w)
        self.stride, self.r = st, st * up
        self.conv = conv or conv_cuda.conv3x3
        self.conv_q = conv_q or conv_cuda.conv3x3_q
        self.trunk_impl = trunk_impl

        def np32(t: torch.Tensor) -> np.ndarray:
            return t.detach().cpu().float().numpy()

        def bf16(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device).to(torch.bfloat16)

        head_k = _expand_in_rgba(np32(model.head.kernel), st, 1 / 255.0)
        # the head's 64 s2d lanes are padded to 128 with zero lanes (and zero
        # kernel rows), as the JAX graph does for its 128-lane contraction
        self.pad_c = 128 - head_k.shape[2] if head_k.shape[2] == 64 else 0
        if self.pad_c:
            head_k = np.concatenate(
                [head_k, np.zeros((3, 3, self.pad_c, head_k.shape[-1]), np.float32)], axis=2)
        self.head = (bf16(head_k), bf16(np32(model.head.bias)))
        self.blocks = [
            tuple((bf16(np32(c.kernel)), bf16(np32(c.bias))) for c in (blk.conv1, blk.conv2))
            for blk in model.res_blocks()
        ]
        self.trunk = (bf16(np32(model.trunk.kernel)), bf16(np32(model.trunk.bias)))
        tail_k, tail_b = _expand_out_rgba(np32(model.tail.kernel), np32(model.tail.bias),
                                          self.r, 255.0)
        self.tail = (bf16(tail_k), bf16(tail_b))
        # taps are multiples of 1/16 (x2) or 1/64 (x4) on integers ≤ 255:
        # the fp32 base is exact in any order
        self.base_k = torch.from_numpy(_bilinear_base_kernel(4, up, st)).to(self.device)
        # the fused kernel's flat params: head, block convs, trunk, tail
        self.trunk_params = (*self.head, *(t for blk in self.blocks for kb in blk for t in kb),
                             *self.trunk, *self.tail)

        self.quant_scales = quant_scales
        if quant_scales is None:
            return
        q = quant_scales

        def qconv(k: np.ndarray, b: Optional[np.ndarray], ax: float, dc: bool = False) -> QConv:
            kq, dq = (_quant_kernel_i8_dc if dc else _quant_kernel_i8)(k)
            return QConv(bf16(kq.astype(np.float32)), conv_cuda.qgrid_scale(dq, ax).to(self.device),
                         None if b is None else torch.from_numpy(b).to(self.device), float(ax))

        self.q_blocks = [
            tuple(qconv(np32(c.kernel), np32(c.bias), q[f"block{i}/{name}"])
                  for name, c in (("conv1", blk.conv1), ("conv2", blk.conv2)))
            for i, blk in enumerate(model.res_blocks())
        ]
        self.q_trunk = qconv(np32(model.trunk.kernel), np32(model.trunk.bias), q["trunk"])
        # the EXPANDED tail (×255, RGBA-interleaved) is quantised, as JAX does
        self.q_tail = qconv(tail_k, tail_b, q["tail"])
        # head and base: normalised-domain maxima, ×255 for the raw u8 input
        self.q_head = (qconv(head_k, np32(model.head.bias), 255.0 * q["head"])
                       if "head" in q else None)
        self.q_base = None
        if "base" in q:
            # on the head's 128-lane input: the padded rows are zero, and the
            # zero lanes edge-pad to zero
            base_k = _bilinear_base_kernel(4, up, st)
            if self.pad_c:
                base_k = np.concatenate(
                    [base_k, np.zeros((3, 3, self.pad_c, base_k.shape[-1]), np.float32)], axis=2)
            self.q_base = qconv(base_k, None, 255.0 * q["base"], dc=True)

    @property
    def quantized(self) -> bool:
        return self.quant_scales is not None

    @property
    def convs_per_frame(self) -> int:
        """Launches of the conv kernel per call (either mode)."""
        return 3 + 2 * len(self.blocks) + (self.quantized and self.q_base is not None)

    def run_trunk(self, s2d_head: torch.Tensor) -> torch.Tensor:
        """The bf16 learned layers, head to tail: bf16 [N, h, w, 128] → bf16
        [N, h, w, r²·4], by `trunk_impl`."""
        if self.trunk_impl == "fused":
            return trunk_cuda.trunk_fused(s2d_head, self.trunk_params, len(self.blocks),
                                          round_sum=True)
        return trunk_cuda.trunk_chain(self.conv, s2d_head, self.trunk_params, len(self.blocks),
                                      round_sum=True)

    def _qconv(self, c: QConv, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        """`_conv_i8(x, kq, dq, b, ax)`: quantise, then the int8-grid conv."""
        return self.conv_q(conv_cuda.quantize_act(x, c.ax), c.kq, c.scale, c.b, relu)

    def run_int8(self, s2d: torch.Tensor, s2d_head: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The int8 branch: (tail, base), bf16 [N, h, w, r²·4] each."""
        xq_head = None
        if self.q_head is not None:
            xq_head = conv_cuda.quantize_act(s2d_head, self.q_head.ax)
            feat = self.conv_q(xq_head, self.q_head.kq, self.q_head.scale, self.q_head.b, False)
        else:
            feat = self.conv(s2d_head, *self.head, False, True)
        c02 = torch.tensor(0.2, dtype=torch.bfloat16, device=feat.device)  # bf16(0.2), as JAX's
        h = feat
        for c1, c2 in self.q_blocks:
            h = h + c02 * self._qconv(c2, self._qconv(c1, h, relu=True))
        h = self._qconv(self.q_trunk, h) + feat
        tail = self._qconv(self.q_tail, h)
        if self.q_base is None:
            return tail, self.base_f32(s2d)
        # VALID on the edge-padded input: SAME over the padded tensor, the
        # interior kept (it reads no zero padding). Quantising commutes with
        # the edge padding, so the head's quantised input serves when the
        # scales agree.
        if xq_head is None or self.q_base.ax != self.q_head.ax:
            xq_head = conv_cuda.quantize_act(s2d_head, self.q_base.ax)
        base = self.conv_q(_edge_pad(xq_head).contiguous(), self.q_base.kq, self.q_base.scale,
                           None, False)
        return tail, base[:, 1:-1, 1:-1, :]

    def base_f32(self, s2d: torch.Tensor) -> torch.Tensor:
        """The fixed bilinear base in fp32 (exact), as bf16."""
        return conv_cuda.conv_valid_f32(_edge_pad(s2d.float()), self.base_k).to(torch.bfloat16)

    def trunk_input(self, img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """u8 [N, H, W, 4] → (the raw s2d, bf16 [N, h, w, st²·4]; the head's
        input, its 64 lanes zero-padded to 128)."""
        if tuple(img.shape[1:3]) != self.in_hw or img.shape[3] != 4 or img.dtype != torch.uint8:
            raise ValueError(f"expected u8 [N, {self.in_hw[0]}, {self.in_hw[1]}, 4], "
                             f"got {img.dtype} {tuple(img.shape)}")
        s2d = _s2d(img.to(torch.bfloat16), self.stride)  # raw 0..255, exact in bf16
        if self.pad_c:
            return s2d, torch.cat([s2d, s2d.new_zeros((*s2d.shape[:3], self.pad_c))], dim=-1)
        return s2d, s2d.contiguous()

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        s2d, s2d_head = self.trunk_input(img)
        if self.quantized:
            tail, base = self.run_int8(s2d, s2d_head)
        else:
            tail, base = self.run_trunk(s2d_head), self.base_f32(s2d)
        phases = tail + base  # [N, h, w, r²·4] raw-scale RGBA-interleaved
        ph_u8 = torch.clamp(torch.round(phases), 0, 255).to(torch.uint8)
        return _d2s(ph_u8, self.r)


def make_serving_fn_fused(model: ESRGANLiteTPU, in_h: int, in_w: int, device=None,
                          conv: Optional[ConvFn] = None, trunk_impl: str = "layers",
                          quant_scales: Optional[dict] = None,
                          conv_q: Optional[ConvQFn] = None) -> FusedServing:
    """`make_serving_fn_fused`: its bf16 branch, or with `quant_scales` its
    int8 branch."""
    return FusedServing(model, in_h, in_w, device, conv, trunk_impl, quant_scales, conv_q)


def make_serving_fn(model: ESRGANLiteTPU, in_h: int, in_w: int, out_h: int, out_w: int,
                    device=None) -> FusedServing:
    """Exact-ratio dispatch of `make_serving_fn` (esrgan_lite.py:1096): the
    fused graph. Its other branch (a ratio the net does not land on, or a
    frame the stride does not divide) is not ported."""
    u = model.upscale
    if (out_h, out_w) != (in_h * u, in_w * u) or in_h % model.stride or in_w % model.stride:
        raise NotImplementedError(
            f"learned serving of {in_w}x{in_h} → {out_w}x{out_h} at x{u}, stride "
            f"{model.stride} (the non-exact-ratio path of make_serving_fn) {NOT_PORTED_ARCH}")
    return FusedServing(model, in_h, in_w, device)


def make_quant_apply(model: ESRGANLiteTPU, scales: dict) -> Callable[[torch.Tensor], torch.Tensor]:
    """The fp32 int8-grid twin of the int8 serving graph (`make_quant_apply`,
    `esrgan_lite.py:806`): the same integer weight grid and activation
    scales, in the [0, 1] domain on RGB, every `_conv_i8` kept in fp32.
    f32 [N, h, w, 3] → f32 [N, uh, uw, 3], on the input's device."""
    st, up = model.stride, model.upscale
    r = st * up

    def np32(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().float().numpy()

    def qconv(k: np.ndarray, b: Optional[torch.Tensor], ax: float, dc: bool = False):
        kq, dq = (_quant_kernel_i8_dc if dc else _quant_kernel_i8)(k)
        return (torch.from_numpy(kq.astype(np.float32)), conv_cuda.qgrid_scale(dq, ax),
                None if b is None else b.detach().float(), float(ax))

    blocks = [tuple(qconv(np32(c.kernel), c.bias, scales[f"block{i}/{name}"])
                    for name, c in (("conv1", blk.conv1), ("conv2", blk.conv2)))
              for i, blk in enumerate(model.res_blocks())]
    trunk = qconv(np32(model.trunk.kernel), model.trunk.bias, scales["trunk"])
    tail = qconv(np32(model.tail.kernel), model.tail.bias, scales["tail"])
    head = qconv(np32(model.head.kernel), model.head.bias, scales["head"]) if "head" in scales else None
    base = (qconv(_bilinear_base_kernel(3, up, st), None, scales["base"], dc=True)
            if "base" in scales else None)

    def conv_i8(x: torch.Tensor, c, valid: bool = False) -> torch.Tensor:
        kq, scale, b, ax = (t.to(x.device) if isinstance(t, torch.Tensor) else t for t in c)
        xq = conv_cuda.quantize_act(x, ax, torch.float32)
        y = (conv_cuda.conv_valid_f32 if valid else conv_cuda.conv3x3_f32)(xq, kq) * scale
        return y if b is None else y + b

    def fn(x: torch.Tensor) -> torch.Tensor:
        s2d = _s2d(x.float(), st)
        if head is not None:
            feat = conv_i8(s2d, head)
        else:
            feat = conv_cuda.conv3x3_f32(s2d, model.head.kernel.to(x.device)) + model.head.bias.to(x.device)
        h = feat
        for c1, c2 in blocks:
            h = h + 0.2 * conv_i8(torch.relu(conv_i8(h, c1)), c2)
        h = conv_i8(h, trunk) + feat
        t = conv_i8(h, tail)
        sp = _edge_pad(s2d)
        if base is not None:
            b = conv_i8(sp, base, valid=True)
        else:
            b = conv_cuda.conv_valid_f32(
                sp, torch.from_numpy(_bilinear_base_kernel(x.shape[-1], up, st)).to(x.device))
        return _d2s(t + b, r)

    return fn


class LearnedUpscaler:
    """``u8 [H, W, 4] → u8 [uH, uW, 4]``, or a batch ``[N, H, W, 4]`` through
    the same graph in one pass. Outputs stay on the device. `arch`, `step`
    and `quantized` (the int8 graph serves) say what serves."""

    def __init__(self, serving: FusedServing, arch: str, step: int) -> None:
        self.serving, self.arch, self.step = serving, arch, step
        self.device = serving.device
        self.quantized = serving.quantized

    def __call__(self, img) -> torch.Tensor:
        x = to_device_u8(img, self.device)
        if x.dim() == 3:
            return self.serving(x[None])[0]
        if x.dim() == 4:
            return self.serving(x)
        raise ValueError(f"expected [H, W, 4] or [N, H, W, 4], got {tuple(x.shape)}")


@functools.lru_cache(maxsize=8)
def _cached_model(arch: str, upscale: int):
    return load_model(arch, upscale)


@functools.lru_cache(maxsize=16)
def _build_pretrained(in_h, in_w, out_h, out_w, prefer, device, trunk_impl) -> LearnedUpscaler:
    if prefer not in ARCH_LADDER:
        raise ValueError(f"prefer must be one of {tuple(ARCH_LADDER)}, got {prefer!r}")
    stages = scale_to_stages(in_h, out_h)
    u = 2 ** stages
    if (out_h, out_w) != (in_h * u, in_w * u):
        raise NotImplementedError(
            f"learned upscale {in_w}x{in_h} → {out_w}x{out_h} is not an exact x{u}: the "
            f"non-exact-ratio serving path {NOT_PORTED_ARCH}")
    for arch, kw, mode in ARCH_LADDER[prefer]:
        st = kw.get("stride", 2)
        if in_h % st or in_w % st:
            continue  # the s2d front end needs stride-divisible frames
        loaded = _cached_model(arch, u)
        if loaded is None:
            continue  # the port carries no weights of this arch at this scale
        scales = load_act_scales(arch, u)  # None unless calibrated at the weights' step
        if mode == "quant" and scales is None:
            continue  # an int8 entry without its calibration
        model, meta = loaded
        # "ultra" serves bf16; the other ladders serve int8 whenever the
        # served checkpoint's scales match
        serving = FusedServing(model, in_h, in_w, device, trunk_impl=trunk_impl,
                               quant_scales=None if prefer == "ultra" else scales)
        return LearnedUpscaler(serving, arch, meta["step"])
    raise NotImplementedError(
        f"no ported learned arch serves x{u} at {in_w}x{in_h}: the stride-2 arch and "
        f"ESRGANLite, which the JAX ladder falls back to, {NOT_PORTED_ARCH}")


def make_pretrained_upscaler(in_h: int, in_w: int, out_h: int, out_w: int,
                             prefer: str = "ultra", device=None,
                             trunk_impl: str = "layers") -> LearnedUpscaler:
    """The learned tier for these sizes on `device` (the card unless "cpu"):
    the first entry of the `prefer` ladder ("ultra", "quality" or
    "performance") whose stride divides the frame, whose weights the port
    carries and, for an int8 entry, whose scales match; bf16 for "ultra",
    int8 for the others where the scales allow. Cached per (sizes, prefer,
    device, trunk_impl); `trunk_impl="fused"` with an int8 ladder raises
    ValueError."""
    return _build_pretrained(in_h, in_w, out_h, out_w, prefer, resolve_device(device),
                             trunk_impl)


def make_pretrained_batch_upscaler(in_h: int, in_w: int, out_h: int, out_w: int,
                                   prefer: str = "ultra", device=None,
                                   trunk_impl: str = "layers") -> LearnedUpscaler:
    """Batched learned serving: u8 [N, H, W, 4] → u8 [N, uH, uW, 4], the batch
    through the graph (one launch per conv layer, or one for the fused trunk),
    not a loop."""
    return make_pretrained_upscaler(in_h, in_w, out_h, out_w, prefer, device, trunk_impl)
