"""ESRGAN-lite, the learned tier — the port of
`nu_scaler_tpu/models/esrgan_lite.py`: its serving paths and its training
half (at the end: the seeded flax-distributed init, the L1 and L1 + gradient
losses, the Adam step in fp32, the dp × tp sharded step on a 2-D
`DeviceMesh`, the int8 calibration), which `models/train.py` drives.

`ESRGANLiteTPU` is the network as an `nn.Module` in the [0, 1] domain: a
space-to-depth(stride) front end, a head conv, residual blocks
(conv → ReLU → conv, 0.2-scaled skip), a trunk conv with the global skip, a
tail conv that emits every output phase, and a fixed bilinear base over the
s2d neighbourhood added back (a dense 3×3 conv, or at stride 8 the
structured "sparse" form with JAX's roundings, `sparse_base`). `ESRGANLite`
is the "lite" net the JAX ladder falls back to: full resolution, 2×
pixel-shuffle stages and an `image_resize` base. Their convs follow flax
`nn.Conv` in the module's dtype: the sum in fp32, rounded to the dtype, then
the bias added in the dtype. In fp32 they are the twins the JAX package's
fidelity gate compares the served bytes with (`bench.py` `_twin_model_fn`:
f32 parameters on f32 input), then resized to the target (`make_twin`).

`make_serving_fn` dispatches as JAX's does (`esrgan_lite.py:1096`):

- `FusedServing`, `make_serving_fn_fused`: the production graph for an
  `ESRGANLiteTPU` at an exact ratio on a frame its stride divides (`:891`),
  u8 RGBA in, u8 RGBA out, in the raw 0..255 domain (1/255 folded into the
  head kernel, 255 into the tail), alpha riding the bilinear base. Its convs
  go through `kernels.conv_cuda.conv3x3`, the port of the Pallas
  `make_conv3x3`, with ``round_sum=True``: the JAX graph's XLA conv rounds
  its sum to bf16 before the bias is added in bf16, and the kernel's
  epilogue does the same. With ``trunk_impl="fused"`` the chain, head to
  tail, is one launch of `kernels.trunk_cuda.trunk_fused`, the port of the
  Pallas `make_trunk_fused`, with the same rounding; "layers" stays the
  default. With ``quant_scales`` (a checkpoint's int8 calibration) it is the
  int8 branch (`:950-1076`) that the "quality" (default) and "performance"
  ladders serve: every residual-block, trunk and tail conv is `_conv_i8` —
  the activation quantised by `conv_cuda.quantize_act`, then
  `conv_cuda.conv3x3_q`, the conv kernel's int8-grid epilogue — and, with
  "head" / "base" scales, the head and the fixed base too.
- `UnfusedServing`: the other branch (`:1171-1181`), for every other
  request: a ratio the net does not land on (its ×2 or ×4 output resized to
  the target by `ops.image_resize`, the port's `jax.image.resize`), and
  ESRGANLite. The model's bf16 forward on [0, 1] RGB, its convs on the same
  kernel, the alpha plane resized on its own. It ignores int8 scales, as
  JAX's does.

Every conv of another width than the kernel's multiples of 128 (the stride-2
arch's 16-lane head and 64 features, tpu8w's 192, the RGB heads and tails,
ESRGANLite's 3, 32 and 128) runs on the same kernel with its weights
zero-padded once at load (`conv_cuda.pad_weights`), which is exact.
`make_quant_apply` is the int8 graph's fp32 twin.

Weights and int8 scales come from the files under
`nu_scaler_tpu_torch/weights/`, written from every orbax checkpoint the JAX
package reads (and ESRGANLite's seed-0 initialisations) by
`tools/export_torch_weights.py`, and from the checkpoints the port's trainer
writes in that format into `models/train.py` `CKPT_ROOT` (`write_weights`).
The serving ladders read, per arch and scale, the newest step in `CKPT_ROOT`
when it holds one, else the committed export (`weights_directory`), as JAX's
read the step its trainer's ``latest.txt`` names; the int8 scales come only
from the sidecar of the weights that serve. `make_pretrained_upscaler` walks
JAX's ladder (`_build_pretrained`, `:591-649`) and serves every request the
JAX package serves.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import hashlib
import json
import shutil
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.kernels import conv_cuda, trunk_cuda
from nu_scaler_tpu_torch.ops.image_resize import image_resize
from nu_scaler_tpu_torch.ops.resample import to_device_u8
from nu_scaler_tpu_torch.parallel import tp

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
LITE = "lite"  # the arch name of ESRGANLite, as JAX's fn.arch reports it
BASE_IMPLS = ("conv", "sparse")


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


@functools.lru_cache(maxsize=8)
def _sparse_base_terms(c: int, upscale: int, stride: int):
    """The fixed base kernel K[3, 3, I, O] factored into the dense centre
    cell's [I, O] matrix and, per neighbour cell offset (oy, ox) in row-major
    order, a pair (A [I, k], columns [k]): A holds the k output phases that
    offset reaches (edge and corner phases only), `columns` their output
    channels — the one-tap scatter B of `esrgan_lite.py:209-229`."""
    k = _bilinear_base_kernel(c, upscale, stride)
    terms = []
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            if oy == 0 and ox == 0:
                continue
            m = k[oy + 1, ox + 1]
            nz = np.nonzero(np.any(m != 0.0, axis=0))[0]
            if nz.size:
                terms.append((oy, ox, np.ascontiguousarray(m[:, nz]), nz))
    return k[1, 1], tuple(terms)


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


def _shift_edge(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[n, i, j] = x[n, clip(i + dy), clip(j + dx)] for |dy|, |dx| ≤ 1
    (`_shift_edge_nhwc`, `esrgan_lite.py:232`)."""
    h, w = x.shape[1], x.shape[2]
    return _edge_pad(x)[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w, :]


def dense_base(s2d: torch.Tensor, c: int, upscale: int, stride: int) -> torch.Tensor:
    """The fixed bilinear base as the dense 3×3 VALID conv on the
    edge-padded s2d, in s2d's dtype. Its taps are multiples of 1/16 (×2) or
    1/64 (×4) on values with 8 significant bits, so the fp32 sum is exact in
    any order and one rounding to the dtype gives the bf16 conv's value."""
    k = torch.from_numpy(_bilinear_base_kernel(c, upscale, stride)).to(s2d.device)
    return conv_cuda.conv_valid_f32(_edge_pad(s2d.float()), k).to(s2d.dtype)


def sparse_base(s2d: torch.Tensor, c: int, upscale: int, stride: int) -> torch.Tensor:
    """The fixed base in its structured form (`base_impl="sparse"`,
    `esrgan_lite.py:314-322,1064-1069`), with JAX's roundings in s2d's
    dtype: the centre cell's product, rounded; then per neighbour offset, in
    order, its reduction over the edge-shifted s2d, rounded, scattered onto
    its output phases (an exact one-tap copy) and added to the running sum,
    rounded. Each product sum is exact in fp32 (as in `dense_base`); the
    roundings of the running sum are not, so their order is kept."""
    center, terms = _sparse_base_terms(c, upscale, stride)
    dt, dev = s2d.dtype, s2d.device

    def rounded_product(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
        with conv_cuda.full_fp32_matmul():
            return (x.float() @ torch.from_numpy(m).to(dev)).to(dt)

    base = rounded_product(s2d, center)
    for oy, ox, a, columns in terms:
        cols = torch.from_numpy(columns).to(dev)
        red = rounded_product(_shift_edge(s2d, oy, ox), a)
        base[..., cols] = base[..., cols] + red  # the other phases add an exact 0
    return base


def fixed_base(s2d: torch.Tensor, c: int, upscale: int, stride: int, base_impl: str) -> torch.Tensor:
    """The fixed bilinear base by `base_impl` ("conv" or "sparse")."""
    return (sparse_base if base_impl == "sparse" else dense_base)(s2d, c, upscale, stride)


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
    …); `params_from_flax` maps a flax tree onto them. `base_impl` "sparse"
    is the structured base the JAX ladder serves at stride 8."""

    def __init__(self, features: int = 64, blocks: int = 3, upscale: int = 2,
                 stride: int = 2, base_impl: str = "conv") -> None:
        super().__init__()
        if base_impl not in BASE_IMPLS:
            raise ValueError(f"base_impl must be one of {BASE_IMPLS}, got {base_impl!r}")
        self.features, self.blocks, self.upscale, self.stride = features, blocks, upscale, stride
        self.base_impl = base_impl
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
        phases = tail + fixed_base(s2d, x01.shape[-1], self.upscale, st, self.base_impl)
        return phases if phase_domain else _d2s(phases, r)


class ESRGANLite(nn.Module):
    """The "lite" net (`esrgan_lite.py:145`) the JAX ladder falls back to: a
    head, residual blocks and a trunk at full resolution, then per stage a
    conv to 4·features, a 2× pixel shuffle and ReLU, a tail to RGB, and the
    input resized bilinearly (`image_resize`, in x's dtype) added back."""

    def __init__(self, features: int = 32, blocks: int = 4, stages: int = 1) -> None:
        super().__init__()
        self.features, self.blocks, self.stages = features, blocks, stages
        self.upscale = 2 ** stages
        self.head = Conv3x3(3, features)
        for i in range(blocks):
            self.add_module(f"block{i}", ResBlock(features))
        self.trunk = Conv3x3(features, features)
        for s in range(stages):
            self.add_module(f"up{s}", Conv3x3(features, 4 * features))
        self.tail = Conv3x3(features, 3)

    def res_blocks(self) -> list[ResBlock]:
        return [getattr(self, f"block{i}") for i in range(self.blocks)]

    def up_convs(self) -> list[Conv3x3]:
        return [getattr(self, f"up{s}") for s in range(self.stages)]

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        """x01: [N, H, W, 3] in [0, 1] → [N, uH, uW, 3], in the parameters'
        dtype."""
        x = x01.to(self.head.kernel.dtype)
        feat = self.head(x)
        h = feat
        for blk in self.res_blocks():
            h = blk(h)
        h = self.trunk(h) + feat
        for up in self.up_convs():
            h = torch.relu(_d2s(up(h), 2))
        out = self.tail(h)
        return image_resize(x, out.shape) + out


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


def weights_directory(arch: str, upscale: int) -> Optional[Path]:
    """Where the weights of `arch` at `upscale` that serve live: the
    trainer's `CKPT_ROOT` (`models/train.py`, read at call time) when it
    holds any, else the committed `WEIGHTS_DIR` when it does, else None.
    The newest step there serves: the trainer saves at start + steps, so it
    is the step JAX's ``latest.txt`` names."""
    from nu_scaler_tpu_torch.models import train

    for directory in (Path(train.CKPT_ROOT), WEIGHTS_DIR):
        if any(directory.glob(f"esrgan_{arch}_x{upscale}_*.json")):
            return directory
    return None


def learned_tier_available(prefer: str) -> bool:
    """True when the trainer's `CKPT_ROOT` or the committed weights hold an
    arch of the `prefer` ladder at ×2 (the role of the reference's library
    probe; `nu_scaler_core/technologies.py:63-73`)."""
    return any(weights_directory(arch, 2) is not None for arch, _, _ in ARCH_LADDER.get(prefer, ()))


def newest_sidecar(directory: Path, pattern: str) -> Optional[dict]:
    """The JSON sidecar of the newest step among the weights whose sidecars
    match the glob `pattern` in `directory`, or None."""
    sidecars = sorted(directory.glob(pattern))
    if not sidecars:
        return None
    return max((json.loads(p.read_text()) for p in sidecars), key=lambda m: m["step"])


def read_weights(npz: Path, sha256: str) -> dict:
    """The nested flax-named numpy tree of `npz`, whose sha256 must be
    `sha256` (its sidecar's); a missing file raises FileNotFoundError."""
    digest = hashlib.sha256(npz.read_bytes()).hexdigest()
    if digest != sha256:
        raise ValueError(f"{npz.name}: sha256 {digest} != its sidecar's {sha256}")
    tree: dict = {}
    with np.load(npz) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def sidecar_scales(meta: Optional[dict]) -> Optional[dict]:
    """The int8 activation scales a sidecar carries (``act_scales``), or None
    when it carries none or they were calibrated at another step than the
    weights' (`nu_scaler_tpu/models/train.py` `load_act_scales`)."""
    blob = meta and meta.get("act_scales")
    if not blob or blob.get("step") != meta["step"]:
        return None
    scales = blob.get("scales")
    return dict(scales) if isinstance(scales, dict) and scales else None


def _sidecar(arch: str, upscale: int, directory: Path = WEIGHTS_DIR) -> Optional[dict]:
    """The JSON sidecar of the newest weights of `arch` at `upscale` in
    `directory` (the committed ones by default), or None."""
    return newest_sidecar(Path(directory), f"esrgan_{arch}_x{upscale}_*.json")


def load_weights(arch: str, upscale: int, directory: Path = WEIGHTS_DIR) -> Optional[tuple[dict, dict]]:
    """(nested flax-named numpy tree, sidecar metadata) of the newest weights
    of `arch` at `upscale` in `directory` (the committed ones by default; a
    trainer's `CKPT_ROOT`), or None when there are none. The npz's sha256
    must match its sidecar's."""
    meta = _sidecar(arch, upscale, directory)
    if meta is None:
        return None
    npz = Path(directory) / f"esrgan_{arch}_x{upscale}_{meta['step']}.npz"
    return read_weights(npz, meta["sha256"]), meta


def load_act_scales(arch: str, upscale: int, directory: Path = WEIGHTS_DIR) -> Optional[dict]:
    """The int8 activation scales of the newest weights of `arch` at
    `upscale` in `directory` (`sidecar_scales`), or None."""
    return sidecar_scales(_sidecar(arch, upscale, directory))


def load_model(arch: str, upscale: int, directory: Path = WEIGHTS_DIR) -> Optional[tuple[nn.Module, dict]]:
    """The fp32 module with the newest weights of `arch` at `upscale` in
    `directory` (`ESRGANLite` for "lite", else `ESRGANLiteTPU`, with the
    sparse base at stride 8 as `_build_pretrained` picks it), and its
    metadata; None when there are no such weights."""
    loaded = load_weights(arch, upscale, directory)
    if loaded is None:
        return None
    tree, meta = loaded
    if arch == LITE:
        model = ESRGANLite(stages=meta["stages"], **meta["model"])
    else:
        kw = meta["model"]
        model = ESRGANLiteTPU(upscale=upscale, base_impl="sparse" if kw["stride"] == 8 else "conv", **kw)
    model.load_state_dict(params_from_flax(tree))
    return model, meta


def flax_arrays(model: nn.Module) -> dict:
    """The module's parameters as float32 numpy arrays under their flax paths
    joined by "/" (``head/kernel``, ``block0/conv1/bias``): the layout of the
    weights' npz files."""
    return {k.replace(".", "/"): v.detach().cpu().float().numpy() for k, v in model.state_dict().items()}


def write_weights(stem: Path, model: nn.Module, meta: dict) -> Path:
    """`stem`.npz (the module's `flax_arrays`) and its sidecar `stem`.json:
    `meta`, the parameter count and the npz's sha256 — the format of
    `tools/export_torch_weights.py`, which `load_weights` reads
    (`write_sidecar_scales` adds the int8 calibration). Returns the npz's
    path."""
    flat = flax_arrays(model)
    stem = Path(stem)
    stem.parent.mkdir(parents=True, exist_ok=True)
    npz = stem.with_suffix(".npz")
    np.savez(npz, **flat)
    meta = {**meta, "parameters": int(sum(a.size for a in flat.values())),
            "sha256": hashlib.sha256(npz.read_bytes()).hexdigest()}
    stem.with_suffix(".json").write_text(json.dumps(meta, indent=1) + "\n")
    return npz


def write_sidecar_scales(sidecar: Path, scales: dict) -> Path:
    """Record the int8 calibration `scales` in the JSON sidecar `sidecar`,
    at the step of its weights, replacing any earlier one."""
    sidecar = Path(sidecar)
    meta = json.loads(sidecar.read_text())
    meta["act_scales"] = {"step": meta["step"], "scales": {k: float(v) for k, v in scales.items()}}
    sidecar.write_text(json.dumps(meta, indent=1) + "\n")
    return sidecar


def copy_export(stem: str, directory: Path) -> Path:
    """Copy the committed export `stem` from `WEIGHTS_DIR` into `directory`
    at its step: its npz, its Adam moments (``{stem}_opt.npz``) where its
    sidecar names them, then its sidecar. Every npz is checked against its
    sidecar's sha256 (`read_weights`) before anything is written. A
    calibration of the committed step writes into this copy, which the
    loaders then read first, since the committed files are never written
    (the role of JAX's ``act_scales.json`` written beside the committed
    orbax step). Returns the copy's sidecar."""
    meta = json.loads((WEIGHTS_DIR / f"{stem}.json").read_text())
    files = [(f"{stem}.npz", meta["sha256"])]
    if "opt_sha256" in meta:
        files.append((f"{stem}_opt.npz", meta["opt_sha256"]))
    for name, sha256 in files:
        read_weights(WEIGHTS_DIR / name, sha256)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for name in [n for n, _ in files] + [f"{stem}.json"]:  # the sidecar last: the loaders glob for it
        shutil.copyfile(WEIGHTS_DIR / name, directory / name)
    return directory / f"{stem}.json"


def make_twin(model: nn.Module, out_h: int, out_w: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The fp32 twin the fidelity gates compare the served bytes with: the
    model in fp32 on [0, 1] RGB [N, H, W, 3], then resized to the target
    (`image_resize`) where the net does not land on it. The model's own
    dtype is left as it is."""
    m32 = copy.deepcopy(model).float()

    def fn(x01: torch.Tensor) -> torch.Tensor:
        out = m32.to(x01.device)(x01.float())
        if tuple(out.shape[1:3]) != (out_h, out_w):
            out = image_resize(out, (out.shape[0], out_h, out_w, out.shape[3]))
        return out

    return fn


# ---------------------------------------------------------------------------
# the serving graphs
# ---------------------------------------------------------------------------

ConvFn = Callable[..., torch.Tensor]  # (x, k, b, relu, round_sum) → bf16
ConvQFn = Callable[..., torch.Tensor]  # (xq, kq, scale, b, relu) → bf16
TRUNK_IMPLS = ("layers", "fused")
INV_255 = 1.0 / 255.0


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _check_trunk_impl(trunk_impl: str) -> None:
    if trunk_impl not in TRUNK_IMPLS:
        raise ValueError(f"trunk_impl must be one of {TRUNK_IMPLS}, got {trunk_impl!r}")


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

    Every conv runs at the kernel's widths: the weights are zero-padded at
    load (`conv_cuda.pad_weights`), the head's s2d lanes zero-padded to them
    (16 → 128 at stride 2, 64 → 128 at stride 4 as the JAX graph does, 256
    at stride 8 as it is), and the tail's padded phases sliced off.

    bf16 (``quant_scales`` None): `trunk_impl` "layers" runs the learned
    layers as one conv launch each, with `conv` (the kernel wrapper by
    default; `conv_cuda.conv3x3_plain` to run the graph on its plain
    version); "fused" runs them as one launch of the fused trunk kernel.

    int8 (``quant_scales``, a checkpoint's calibration): the blocks, trunk and
    tail — and the head and the fixed base where the scales name them — run
    on the int8 grid through `conv_q` (`conv_cuda.conv3x3_q` by default;
    `conv_cuda.conv3x3_q_plain` for the plain version); a missing "head" /
    "base" leaves the bf16 head and the exact base. The fused trunk is bf16
    only, as JAX's is.

    The base is the model's `base_impl`: the dense conv, or at stride 8 the
    sparse form in bf16 with JAX's roundings (never on the int8 grid there,
    `esrgan_lite.py:990`)."""

    def __init__(self, model: ESRGANLiteTPU, in_h: int, in_w: int, device,
                 conv: Optional[ConvFn] = None, trunk_impl: str = "layers",
                 quant_scales: Optional[dict] = None, conv_q: Optional[ConvQFn] = None) -> None:
        _check_trunk_impl(trunk_impl)
        if quant_scales is not None and trunk_impl != "layers":
            raise ValueError("trunk_impl='fused' serves bf16 only: the int8 ladders run "
                             "trunk_impl='layers'")
        st, up = model.stride, model.upscale
        if in_h % st or in_w % st:
            raise ValueError(f"{in_w}x{in_h} is not a multiple of the stride {st}")
        self.device = resolve_device(device)
        self.in_hw = (in_h, in_w)
        self.stride, self.upscale, self.r = st, up, st * up
        self.base_impl = model.base_impl
        self.conv = conv or conv_cuda.conv3x3
        self.conv_q = conv_q or conv_cuda.conv3x3_q
        self.trunk_impl = trunk_impl

        def bf16(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device).to(torch.bfloat16)

        # the head's s2d lanes, and the RGBA-interleaved phases the tail emits
        self.head_lanes = conv_cuda.lanes(st * st * 4)
        self.phases = self.r * self.r * 4
        head_k, head_b = conv_cuda.pad_weights(_expand_in_rgba(_np32(model.head.kernel), st, 1 / 255.0),
                                               _np32(model.head.bias))
        blocks = [tuple(conv_cuda.pad_weights(_np32(c.kernel), _np32(c.bias)) for c in (blk.conv1, blk.conv2))
                  for blk in model.res_blocks()]
        trunk_k, trunk_b = conv_cuda.pad_weights(_np32(model.trunk.kernel), _np32(model.trunk.bias))
        tail_k, tail_b = conv_cuda.pad_weights(*_expand_out_rgba(_np32(model.tail.kernel),
                                                                 _np32(model.tail.bias), self.r, 255.0))
        self.head = (bf16(head_k), bf16(head_b))
        self.blocks = [tuple((bf16(k), bf16(b)) for k, b in blk) for blk in blocks]
        self.trunk = (bf16(trunk_k), bf16(trunk_b))
        self.tail = (bf16(tail_k), bf16(tail_b))
        # the fused kernel's flat params: head, block convs, trunk, tail
        self.trunk_params = (*self.head, *(t for blk in self.blocks for kb in blk for t in kb),
                             *self.trunk, *self.tail)
        # each bf16 conv's (Cin, Cout) in JAX's graph, before the padding to
        # the kernel's widths (JAX pads a 64-lane head input to 128 itself)
        f, cin = model.features, st * st * 4
        self.widths = ((128 if cin == 64 else cin, f), *[(f, f)] * (2 * len(blocks) + 1), (f, self.phases))

        self.quant_scales = quant_scales
        if quant_scales is None:
            return
        q = quant_scales

        def qconv(k: np.ndarray, b: Optional[np.ndarray], ax: float, dc: bool = False) -> QConv:
            # a padded row or column is zero: kq 0, and its channel's scale 1
            kq, dq = (_quant_kernel_i8_dc if dc else _quant_kernel_i8)(k)
            return QConv(bf16(kq.astype(np.float32)), conv_cuda.qgrid_scale(dq, ax).to(self.device),
                         None if b is None else torch.from_numpy(b).to(self.device), float(ax))

        self.q_blocks = [tuple(qconv(k, b, q[f"block{i}/{name}"]) for (k, b), name in zip(blk, ("conv1", "conv2")))
                         for i, blk in enumerate(blocks)]
        self.q_trunk = qconv(trunk_k, trunk_b, q["trunk"])
        # the EXPANDED tail (×255, RGBA-interleaved) is quantised, as JAX does
        self.q_tail = qconv(tail_k, tail_b, q["tail"])
        # head and base: normalised-domain maxima, ×255 for the raw u8 input
        self.q_head = qconv(head_k, head_b, 255.0 * q["head"]) if "head" in q else None
        self.q_base = None
        if "base" in q and self.base_impl == "conv":
            # on the head's padded input: the padded rows are zero, and the
            # zero lanes edge-pad to zero
            base_k = conv_cuda.pad_weights(_bilinear_base_kernel(4, up, st))
            self.q_base = qconv(base_k, None, 255.0 * q["base"], dc=True)

    @property
    def quantized(self) -> bool:
        return self.quant_scales is not None

    @property
    def convs_per_frame(self) -> int:
        """Launches of the conv kernel per call (either mode)."""
        return 3 + 2 * len(self.blocks) + (self.quantized and self.q_base is not None)

    def run_trunk(self, s2d_head: torch.Tensor) -> torch.Tensor:
        """The bf16 learned layers, head to tail: bf16 [N, h, w, head_lanes]
        → bf16 [N, h, w, r²·4], by `trunk_impl`."""
        if self.trunk_impl == "fused":
            out = trunk_cuda.trunk_fused(s2d_head, self.trunk_params, len(self.blocks), round_sum=True)
        else:
            out = trunk_cuda.trunk_chain(self.conv, s2d_head, self.trunk_params, len(self.blocks),
                                         round_sum=True)
        return out[..., : self.phases]

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
        tail = self._qconv(self.q_tail, h)[..., : self.phases]
        if self.q_base is None:
            return tail, self.base(s2d)
        # VALID on the edge-padded input: SAME over the padded tensor, the
        # interior kept (it reads no zero padding). Quantising commutes with
        # the edge padding, so the head's quantised input serves when the
        # scales agree.
        if xq_head is None or self.q_base.ax != self.q_head.ax:
            xq_head = conv_cuda.quantize_act(s2d_head, self.q_base.ax)
        base = self.conv_q(_edge_pad(xq_head).contiguous(), self.q_base.kq, self.q_base.scale,
                           None, False)
        return tail, base[:, 1:-1, 1:-1, : self.phases]

    def base(self, s2d: torch.Tensor) -> torch.Tensor:
        """The fixed bilinear base on the raw RGBA s2d, bf16."""
        return fixed_base(s2d, 4, self.upscale, self.stride, self.base_impl)

    def trunk_input(self, img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """u8 [N, H, W, 4] → (the raw s2d, bf16 [N, h, w, st²·4]; the head's
        input, its lanes zero-padded to the kernel's width)."""
        if tuple(img.shape[1:3]) != self.in_hw or img.shape[3] != 4 or img.dtype != torch.uint8:
            raise ValueError(f"expected u8 [N, {self.in_hw[0]}, {self.in_hw[1]}, 4], "
                             f"got {img.dtype} {tuple(img.shape)}")
        s2d = _s2d(img.to(torch.bfloat16), self.stride)  # raw 0..255, exact in bf16
        return s2d, conv_cuda.pad_lanes(s2d, self.head_lanes)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        s2d, s2d_head = self.trunk_input(img)
        if self.quantized:
            tail, base = self.run_int8(s2d, s2d_head)
        else:
            tail, base = self.run_trunk(s2d_head), self.base(s2d)
        phases = tail + base  # [N, h, w, r²·4] raw-scale RGBA-interleaved
        ph_u8 = torch.clamp(torch.round(phases), 0, 255).to(torch.uint8)
        return _d2s(ph_u8, self.r)


class UnfusedServing:
    """The other branch of `make_serving_fn` (`esrgan_lite.py:1171-1181`):
    u8 RGBA [N, H, W, 4] → u8 RGBA [N, out_h, out_w, 4] for the whole batch,
    for an `ESRGANLiteTPU` at a ratio it does not land on, or `ESRGANLite`:

        f = u8 → fp32 · (1/255); RGB → bf16
        out = the model's bf16 forward → fp32, resized to the target where
              it differs (`image_resize`)
        alpha = image_resize(f's alpha)
        clip(round(· 255)) → u8

    The forward's convs run on the conv kernel through `conv` (the wrapper
    by default; `conv_cuda.conv3x3_plain` for the plain version) with
    ``round_sum=True``, flax `nn.Conv`'s rounding in bf16, on weights
    zero-padded at load; `trunk_impl="fused"` runs an `ESRGANLiteTPU`'s
    chain as one launch of the fused trunk. The base is the model's: dense
    or sparse on the s2d, or `image_resize` for ESRGANLite. int8 scales do
    not reach this branch, as in JAX."""

    def __init__(self, model: nn.Module, in_h: int, in_w: int, out_h: int, out_w: int, device,
                 conv: Optional[ConvFn] = None, trunk_impl: str = "layers") -> None:
        _check_trunk_impl(trunk_impl)
        self.lite = isinstance(model, ESRGANLite)
        if self.lite and trunk_impl != "layers":
            raise ValueError(f"trunk_impl={trunk_impl!r}: ESRGANLite's {model.features}-feature "
                             f"trunk ends in {4 * model.features}-channel pixel-shuffle stages, not "
                             f"the head-to-tail chain the fused trunk runs; it serves 'layers'")
        st = 1 if self.lite else model.stride
        if in_h % st or in_w % st:
            raise ValueError(f"{in_w}x{in_h} is not a multiple of the stride {st}")
        self.device = resolve_device(device)
        self.in_hw, self.out_hw = (in_h, in_w), (out_h, out_w)
        self.stride, self.upscale = st, model.upscale
        self.conv = conv or conv_cuda.conv3x3
        self.trunk_impl = trunk_impl
        self.quantized = False  # the branch serves bf16 whatever the scales

        def padded(c: Conv3x3) -> tuple[torch.Tensor, torch.Tensor]:
            k, b = conv_cuda.pad_weights(_np32(c.kernel), _np32(c.bias))
            return (torch.from_numpy(k).to(self.device).to(torch.bfloat16),
                    torch.from_numpy(b).to(self.device).to(torch.bfloat16))

        self.n_blocks = model.blocks
        chain = [model.head, *(c for blk in model.res_blocks() for c in (blk.conv1, blk.conv2)),
                 model.trunk]
        if self.lite:
            # head to the first up conv is the trunk chain's shape (its
            # "tail" the 4·features up conv, ReLU after the shuffle)
            chain += [model.up_convs()[0]]
            self.ups = [padded(c) for c in model.up_convs()[1:]]
            self.rgb_tail = padded(model.tail)
        else:
            chain += [model.tail]
            self.r = st * model.upscale
            self.base_impl = model.base_impl
        self.chain_params = tuple(t for c in chain for t in padded(c))
        self.head_lanes = self.chain_params[0].shape[2]
        # each conv's (Cin, Cout) in the model, before the padding
        self.widths = tuple(tuple(c.kernel.shape[2:]) for c in chain + ([*model.up_convs()[1:], model.tail]
                                                                         if self.lite else []))

    @property
    def convs_per_frame(self) -> int:
        """Launches of the conv kernel per call ("layers")."""
        return 3 + 2 * self.n_blocks + (len(self.ups) + 1 if self.lite else 0)

    def run_chain(self, x: torch.Tensor) -> torch.Tensor:
        """Head to tail (or to ESRGANLite's first up conv), bf16, on the
        padded widths, by `trunk_impl`."""
        x = conv_cuda.pad_lanes(x, self.head_lanes)
        if self.trunk_impl == "fused":
            return trunk_cuda.trunk_fused(x, self.chain_params, self.n_blocks, round_sum=True)
        return trunk_cuda.trunk_chain(self.conv, x, self.chain_params, self.n_blocks, round_sum=True)

    def net(self, rgb: torch.Tensor) -> torch.Tensor:
        """The model's bf16 forward: bf16 [N, H, W, 3] in [0, 1] → bf16
        [N, uH, uW, 3]."""
        if self.lite:
            h = torch.relu(_d2s(self.run_chain(rgb), 2))
            for k, b in self.ups:
                h = torch.relu(_d2s(conv_cuda.conv3x3_padded(h, k, b, k.shape[3], False, True, self.conv), 2))
            out = conv_cuda.conv3x3_padded(h, *self.rgb_tail, 3, False, True, self.conv)
            return image_resize(rgb, out.shape) + out
        s2d = _s2d(rgb, self.stride)
        tail = self.run_chain(s2d)[..., : self.r * self.r * 3]
        return _d2s(tail + fixed_base(s2d, 3, self.upscale, self.stride, self.base_impl), self.r)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if tuple(img.shape[1:3]) != self.in_hw or img.shape[3] != 4 or img.dtype != torch.uint8:
            raise ValueError(f"expected u8 [N, {self.in_hw[0]}, {self.in_hw[1]}, 4], "
                             f"got {img.dtype} {tuple(img.shape)}")
        n = img.shape[0]
        f = img.float() * torch.tensor(INV_255, dtype=torch.float32, device=img.device)
        out = self.net(f[..., :3].to(torch.bfloat16)).float()
        if tuple(out.shape[1:3]) != self.out_hw:
            out = image_resize(out, (n, *self.out_hw, 3))
        alpha = image_resize(f[..., 3:], (n, *self.out_hw, 1))
        full = torch.cat([out, alpha], dim=-1)
        return torch.clamp(torch.round(full * 255.0), 0, 255).to(torch.uint8)


Serving = Union[FusedServing, UnfusedServing]


def make_serving_fn_fused(model: ESRGANLiteTPU, in_h: int, in_w: int, device=None,
                          conv: Optional[ConvFn] = None, trunk_impl: str = "layers",
                          quant_scales: Optional[dict] = None,
                          conv_q: Optional[ConvQFn] = None) -> FusedServing:
    """`make_serving_fn_fused`: its bf16 branch, or with `quant_scales` its
    int8 branch."""
    return FusedServing(model, in_h, in_w, device, conv, trunk_impl, quant_scales, conv_q)


def make_serving_fn(model: nn.Module, in_h: int, in_w: int, out_h: int, out_w: int, device=None,
                    conv: Optional[ConvFn] = None, trunk_impl: str = "layers",
                    quant_scales: Optional[dict] = None) -> Serving:
    """The dispatch of `make_serving_fn` (`esrgan_lite.py:1096-1120`): an
    `ESRGANLiteTPU` at its exact ratio serves the fused graph (int8 with
    `quant_scales`; a frame its stride does not divide raises ValueError, as
    JAX's s2d cannot take it); every other request the unfused branch,
    which ignores `quant_scales`. JAX's middle branch serves only
    ``conv_impl != "conv"``, which no ladder builds; the port has no
    counterpart."""
    u = model.upscale
    if isinstance(model, ESRGANLiteTPU) and (out_h, out_w) == (in_h * u, in_w * u):
        return FusedServing(model, in_h, in_w, device, conv, trunk_impl, quant_scales)
    return UnfusedServing(model, in_h, in_w, out_h, out_w, device, conv, trunk_impl)


def make_quant_apply(model: ESRGANLiteTPU, scales: dict) -> Callable[[torch.Tensor], torch.Tensor]:
    """The fp32 int8-grid twin of the int8 serving graph (`make_quant_apply`,
    `esrgan_lite.py:806`): the same integer weight grid and activation
    scales, in the [0, 1] domain on RGB, every `_conv_i8` kept in fp32.
    f32 [N, h, w, 3] → f32 [N, uh, uw, 3], on the input's device."""
    st, up = model.stride, model.upscale
    r = st * up

    def qconv(k: np.ndarray, b: Optional[torch.Tensor], ax: float, dc: bool = False):
        kq, dq = (_quant_kernel_i8_dc if dc else _quant_kernel_i8)(k)
        return (torch.from_numpy(kq.astype(np.float32)), conv_cuda.qgrid_scale(dq, ax),
                None if b is None else b.detach().float(), float(ax))

    blocks = [tuple(qconv(_np32(c.kernel), c.bias, scales[f"block{i}/{name}"])
                    for name, c in (("conv1", blk.conv1), ("conv2", blk.conv2)))
              for i, blk in enumerate(model.res_blocks())]
    trunk = qconv(_np32(model.trunk.kernel), model.trunk.bias, scales["trunk"])
    tail = qconv(_np32(model.tail.kernel), model.tail.bias, scales["tail"])
    head = qconv(_np32(model.head.kernel), model.head.bias, scales["head"]) if "head" in scales else None
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
    """``u8 [H, W, 4] → u8 [OH, OW, 4]``, or a batch ``[N, H, W, 4]`` through
    the same graph in one pass. Outputs stay on the device. `arch`, `step`
    and `directory` say what serves (JAX's ``fn.arch``) and from where, and
    `quantized` whether the int8 graph serves."""

    def __init__(self, serving: Serving, arch: str, step: int, directory: Path) -> None:
        self.serving, self.arch, self.step, self.directory = serving, arch, step, Path(directory)
        self.device = serving.device
        self.quantized = serving.quantized

    def __call__(self, img) -> torch.Tensor:
        x = to_device_u8(img, self.device)
        if x.dim() == 3:
            return self.serving(x[None])[0]
        if x.dim() == 4:
            return self.serving(x)
        raise ValueError(f"expected [H, W, 4] or [N, H, W, 4], got {tuple(x.shape)}")


@functools.lru_cache(maxsize=16)
def _cached_model(arch: str, upscale: int) -> Optional[tuple[nn.Module, dict, Path]]:
    """(module, sidecar, directory) of the weights of `arch` at `upscale`
    that serve (`weights_directory`), or None. Cached: a process keeps
    serving what it loaded first, as JAX's cached factories do."""
    directory = weights_directory(arch, upscale)
    loaded = None if directory is None else load_model(arch, upscale, directory)
    return None if loaded is None else (*loaded, directory)


@functools.lru_cache(maxsize=16)
def _build_pretrained(in_h, in_w, out_h, out_w, prefer, device, trunk_impl) -> LearnedUpscaler:
    """JAX's `_build_pretrained` (`esrgan_lite.py:591-649`): the first entry
    of the ladder whose stride divides the frame, whose weights serve (the
    newest in the trainer's `CKPT_ROOT`, else the committed export) and, for
    a "quant" entry, whose own sidecar carries scales at their step; else
    ESRGANLite at the stage count. `make_serving_fn` then picks the graph."""
    stages = scale_to_stages(in_h, out_h)
    u = 2 ** stages
    for arch, kw, mode in ARCH_LADDER[prefer]:
        st = kw.get("stride", 2)
        if in_h % st or in_w % st:
            continue  # the s2d front end needs stride-divisible frames
        loaded = _cached_model(arch, u)
        if loaded is None:
            continue  # no weights of this arch at this scale
        model, meta, directory = loaded
        scales = sidecar_scales(meta)  # None unless calibrated at the weights' step
        if mode == "quant" and scales is None:
            continue  # an int8 entry without its calibration
        # "ultra" serves bf16; the other ladders serve int8 whenever the
        # served checkpoint's scales match and the fused graph serves
        serving = make_serving_fn(model, in_h, in_w, out_h, out_w, device, trunk_impl=trunk_impl,
                                  quant_scales=None if prefer == "ultra" else scales)
        return LearnedUpscaler(serving, arch, meta["step"], directory)
    loaded = _cached_model(LITE, u)
    if loaded is None:
        raise ValueError(f"no learned weights serve x{u}: the port carries ESRGANLite at "
                         f"x2, x4 and x8, as the JAX ladder's reach")
    model, meta, directory = loaded
    return LearnedUpscaler(make_serving_fn(model, in_h, in_w, out_h, out_w, device,
                                           trunk_impl=trunk_impl), LITE, meta["step"], directory)


def make_pretrained_upscaler(in_h: int, in_w: int, out_h: int, out_w: int,
                             prefer: str = "quality", device=None,
                             trunk_impl: str = "layers") -> LearnedUpscaler:
    """The learned tier for these sizes on `device` (the card unless "cpu"),
    as the JAX package's `make_pretrained_upscaler` serves it: the `prefer`
    ladder ("quality", the default; "ultra"; "performance"; any other name
    serves "quality"), bf16 for "ultra", int8 for the others where the
    served checkpoint's scales match and the ratio is exact. Cached per
    (sizes, prefer, device, trunk_impl); `trunk_impl="fused"` with the int8
    graph or ESRGANLite raises ValueError."""
    if prefer not in ARCH_LADDER:
        prefer = "quality"
    return _build_pretrained(in_h, in_w, out_h, out_w, prefer, resolve_device(device), trunk_impl)


def make_pretrained_batch_upscaler(in_h: int, in_w: int, out_h: int, out_w: int,
                                   prefer: str = "quality", device=None,
                                   trunk_impl: str = "layers") -> LearnedUpscaler:
    """Batched learned serving: u8 [N, H, W, 4] → u8 [N, OH, OW, 4], the batch
    through the graph (one launch per conv layer, or one for the fused trunk),
    not a loop, as JAX's vmap of the single-frame graph."""
    return make_pretrained_upscaler(in_h, in_w, out_h, out_w, prefer, device, trunk_impl)


def make_fast_upscaler(in_h: int, in_w: int, out_h: int, out_w: int, device=None) -> LearnedUpscaler:
    """The "performance" learned tier (`esrgan_lite.py:525-534`): the fast
    ladder, tpu4b1 first, then the stride-8 trunks, then the quality order."""
    return make_pretrained_upscaler(in_h, in_w, out_h, out_w, "performance", device)


# ---------------------------------------------------------------------------
# training (`esrgan_lite.py:344-389`) and the int8 calibration (`:746-803`)
# ---------------------------------------------------------------------------

# the std of a standard normal truncated to [-2, 2]: flax's `lecun_normal`
# divides its std by it, so the truncated draw has variance 1/fan_in
TRUNCATED_STD = 0.87962566103423978


def init_module(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise every 3×3 conv of `model` in place, in module order, with
    flax's distributions: the kernel `lecun_normal` (a normal of std
    sqrt(1/fan_in) / `TRUNCATED_STD`, fan_in = 9·Cin, truncated to two of its
    stds, so its variance is 1/fan_in), the bias zero. The draws come from a
    `torch.Generator` seeded with `seed`; JAX's PRNG cannot be reproduced, so
    the values differ from flax's `init` with `PRNGKey(seed)` while the
    distribution is the same. Returns `model`."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in (m for m in model.modules() if isinstance(m, Conv3x3)):
            std = (1.0 / (9 * conv.kernel.shape[2])) ** 0.5 / TRUNCATED_STD
            k = torch.empty(conv.kernel.shape, dtype=torch.float32)
            nn.init.trunc_normal_(k, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            conv.kernel.copy_(k)
            conv.bias.zero_()
    return model


def init_params(seed: int = 0, stages: int = 1, features: int = 32, blocks: int = 4) -> ESRGANLite:
    """A fresh `ESRGANLite` (`init_params`, `esrgan_lite.py:344`), fp32 on
    the CPU, initialised by `init_module(·, seed)`."""
    return init_module(ESRGANLite(features=features, blocks=blocks, stages=stages), seed)


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l1_grad(pred: torch.Tensor, target: torch.Tensor, w: float = 0.5) -> torch.Tensor:
    """L1 plus the L1 of the differences along H and W (axes 1 and 2 of
    NHWC), each a mean over all its elements."""
    gy = l1(pred[:, 1:] - pred[:, :-1], target[:, 1:] - target[:, :-1])
    gx = l1(pred[:, :, 1:] - pred[:, :, :-1], target[:, :, 1:] - target[:, :, :-1])
    return l1(pred, target) + w * (gy + gx)


def l1_loss(model: nn.Module, lr_batch: torch.Tensor, hr_batch: torch.Tensor) -> torch.Tensor:
    """`l1_loss` (`esrgan_lite.py:355`): mean |model(lr) − hr|."""
    return l1(model(lr_batch), hr_batch)


def l1_grad_loss(model: nn.Module, lr_batch: torch.Tensor, hr_batch: torch.Tensor,
                 w: float = 0.5) -> torch.Tensor:
    """`l1_grad_loss` (`esrgan_lite.py:360`): L1 + w·(the gradient
    differences' L1), which pushes local structure (SSIM)."""
    return l1_grad(model(lr_batch), hr_batch, w)


def loss_of(kind: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The loss on (prediction, target) a loss name selects: "l1_grad", else
    L1, as JAX's `make_train_step` picks it."""
    return l1_grad if kind == "l1_grad" else l1


@contextlib.contextmanager
def fp32_training():
    """Matmuls and cuDNN convs in full fp32 inside the block (no TF32 on the
    card: the forward's tap matmuls and autograd's backward ones alike), as
    the JAX trainer's fp32 XLA convs, through the per-backend switches only
    (`conv_cuda.full_fp32_matmul`, `torch.backends.cudnn.conv.fp32_precision`);
    the earlier settings are restored after."""
    cudnn_conv = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    try:
        with conv_cuda.full_fp32_matmul():
            yield
    finally:
        torch.backends.cudnn.conv.fp32_precision = cudnn_conv


def adam(model: nn.Module, lr: float) -> torch.optim.Optimizer:
    """Make `model`'s parameters trainable (serving modules keep them
    frozen) and return Adam over them with `optax.adam`'s constants:
    lr·m̂/(√v̂ + 1e-8), β = (0.9, 0.999), the step counted from 1."""
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_step(model: nn.Module, optimizer: torch.optim.Optimizer,
              loss_fn: Callable[..., torch.Tensor]) -> Callable[..., tuple]:
    """step(*batch) → (model, optimizer, loss): `loss_fn(*batch)` forward and
    backward under `fp32_training`, then one optimizer step, in place. The
    loss comes back detached, on the device."""

    def step(*batch):
        with fp32_training():
            optimizer.zero_grad(set_to_none=True)
            lv = loss_fn(*batch)
            lv.backward()
            optimizer.step()
        return model, optimizer, lv.detach()

    return step


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, loss: str = "l1"):
    """`make_train_step` (`esrgan_lite.py:379`): step(lr_batch, hr_batch) →
    (model, optimizer, loss), the L1 or L1 + gradient loss ("l1_grad") of
    the module's fp32 forward (its convs `conv_cuda.conv3x3_f32`, nine tap
    matmuls), autograd's gradients and one Adam step (`adam`)."""
    fn = loss_of(loss)
    return make_step(model, optimizer, lambda lr_b, hr_b: fn(model(lr_b), hr_b))


# ---------------------------------------------------------------------------
# the dp × tp train step (`esrgan_lite.py:392-434`) on a 2-D DeviceMesh
# ---------------------------------------------------------------------------


def param_shardings(model: nn.Module, mesh) -> dict:
    """The tp layout (`param_shardings`, `esrgan_lite.py:392`): a 4-D (HWIO)
    kernel whose last axis divides by the mesh's "model" size splits on it,
    ``(None, None, None, "model")``; a 1-D leaf that divides splits,
    ``("model",)``; any other leaf is replicated, ``()``. The specs are
    JAX's PartitionSpec entries, by parameter name."""
    m = mesh.size(mesh.mesh_dim_names.index("model"))

    def spec(p: torch.Tensor) -> tuple:
        if p.ndim == 4 and p.shape[-1] % m == 0:
            return (None, None, None, "model")
        if p.ndim == 1 and p.shape[0] % m == 0:
            return ("model",)
        return ()

    return {name: spec(p) for name, p in model.named_parameters()}


class ShardedConv3x3(Conv3x3):
    """A `Conv3x3` column-parallel over the mesh's "model" axis: it holds
    this rank's slice of the output channels (kernel and bias), takes its
    input replicated (`tp.copy_to_model`) and gives the full channels back
    (`tp.gather_channels`); over one rank it is the plain conv."""

    def __init__(self, conv: Conv3x3, group) -> None:
        nn.Module.__init__(self)
        self.group = group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        w = conv.kernel.shape[-1] // size
        mine = slice(rank * w, (rank + 1) * w)
        self.kernel = nn.Parameter(conv.kernel.detach()[..., mine].clone(), requires_grad=False)
        self.bias = nn.Parameter(conv.bias.detach()[mine].clone(), requires_grad=False)
        self.split = size > 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.split:
            return super().forward(x)
        return tp.gather_channels(super().forward(tp.copy_to_model(x, self.group)), self.group)


def _swap_convs(model: nn.Module, make: Callable[[str, Conv3x3], nn.Module], keep=()) -> nn.Module:
    """A copy of `model` with each `Conv3x3` child named n replaced by
    ``make(n, conv)``; the objects in `keep` (process groups) are shared,
    not copied."""
    out = copy.deepcopy(model, memo={id(k): k for k in keep})
    for name, conv in [(n, m) for n, m in out.named_modules() if isinstance(m, Conv3x3)]:
        parent, _, leaf = name.rpartition(".")
        setattr(out.get_submodule(parent), leaf, make(name, conv))
    return out


def make_sharded_train_step(model: nn.Module, lr: float, mesh):
    """The port of `make_sharded_train_step` (`esrgan_lite.py:409`): the L1
    train step with the batch split over the mesh's "data" axis and every
    conv whose output channels divide by the "model" size split over it
    (`param_shardings`), run on every rank of the mesh's world.

    Returns (step, sharded_model, optimizer), as JAX returns (step,
    sharded_params, opt_state): `sharded_model` a copy of `model` on this
    rank's device whose split convs are `ShardedConv3x3`, the module's own
    forward unchanged; `optimizer` `adam` over its local parameters with
    fresh moments. ``step(lr_batch, hr_batch)`` takes the global batch (N
    must divide by the "data" size, as JAX's ``P("data")``), runs this
    rank's part forward and backward under `fp32_training`, averages the
    gradients over "data" (one all-reduce of one flat buffer, the loss in
    it), takes one Adam step and returns (sharded_model, optimizer, the
    global L1 loss) on every rank."""
    specs = param_shardings(model, mesh)
    model_group, data_group = mesh.get_group("model"), mesh.get_group("data")
    device = tp.rank_device(mesh)
    sharded = _swap_convs(
        model, lambda n, c: ShardedConv3x3(c, model_group) if specs[f"{n}.kernel"] else c).to(device)
    optimizer = adam(sharded, lr)
    params = list(sharded.parameters())
    d, r = dist.get_world_size(data_group), dist.get_rank(data_group)

    def step(lr_batch, hr_batch):
        n = int(lr_batch.shape[0])
        if n % d or int(hr_batch.shape[0]) != n:
            raise ValueError(f"a global batch of {n} (targets {hr_batch.shape[0]}) does not split over "
                             f"the {d} data ranks")
        k = n // d
        lr_b, hr_b = (torch.as_tensor(b)[r * k: (r + 1) * k].to(device) for b in (lr_batch, hr_batch))
        with fp32_training():
            optimizer.zero_grad(set_to_none=True)
            lv = l1_loss(sharded, lr_b, hr_b)
            lv.backward()
            if d > 1:
                flat = torch.cat([p.grad.reshape(-1) for p in params] + [lv.detach().reshape(1)])
                tp.all_reduce(flat, data_group).div_(d)
                for p, g in zip(params, flat[:-1].split([p.numel() for p in params])):
                    p.grad.copy_(g.view_as(p))
                lv = flat[-1]
            optimizer.step()
        return sharded, optimizer, lv.detach()

    return step, sharded, optimizer


def gather_model(sharded: nn.Module, mesh) -> nn.Module:
    """The full module of a sharded one (`make_sharded_train_step`) on every
    rank, on this rank's device, its parameters frozen as a served module's:
    each split conv's slices gathered over "model" in rank order, the bytes
    the ranks hold."""
    group = mesh.get_group("model")

    def full(_, conv: Conv3x3) -> Conv3x3:
        if not isinstance(conv, ShardedConv3x3):
            return conv
        out = Conv3x3(conv.kernel.shape[2], conv.kernel.shape[3] * dist.get_world_size(group))
        out.to(conv.kernel.device)
        with torch.no_grad():
            for mine, whole in ((conv.kernel, out.kernel), (conv.bias, out.bias)):
                whole.copy_(tp.all_gather_last(mine.detach(), group) if conv.split else mine)
        return out

    out = _swap_convs(sharded, full, keep=(group,))
    for p in out.parameters():
        p.requires_grad_(False)
    return out


def amax(t: torch.Tensor) -> float:
    return float(torch.max(torch.abs(t)))


def conv_f32(x: torch.Tensor, conv: Conv3x3) -> torch.Tensor:
    """`conv` in fp32 on x's device, whatever the module's dtype and device:
    the calibrations' conv (JAX's `conv_f`)."""
    k, b = conv.kernel.to(x.device), conv.bias.to(x.device)
    return conv_cuda.conv3x3_f32(x, k) + b.float()


def calibrate_trunk_scales(model: ESRGANLiteTPU, lr_batch) -> dict:
    """Per-conv-input activation maxima of the int8 trunk (`esrgan_lite.py:746`),
    in the [0, 1] domain of the fp32 forward, on the module's device.
    `lr_batch`: f32 RGB [N, h, w, 3] in [0, 1] (an array or a tensor) from
    training clips (seeds 100..), never the held-out 900+. Returns
    {"block{i}/conv1": amax, "block{i}/conv2": …, "trunk": …, "tail": …}."""
    x = torch.as_tensor(lr_batch, dtype=torch.float32, device=model.head.kernel.device)
    scales: dict = {}
    with torch.no_grad():
        feat = conv_f32(_s2d(x, model.stride), model.head)
        h = feat
        for i, blk in enumerate(model.res_blocks()):
            scales[f"block{i}/conv1"] = amax(h)
            t1 = torch.relu(conv_f32(h, blk.conv1))
            scales[f"block{i}/conv2"] = amax(t1)
            h = h + 0.2 * conv_f32(t1, blk.conv2)
        scales["trunk"] = amax(h)
        h = conv_f32(h, model.trunk) + feat
        scales["tail"] = amax(h)
    return scales


def default_trunk_scales(model: ESRGANLiteTPU, n_clips: int = 4) -> dict:
    """`calibrate_trunk_scales` on crops of the training clips (seeds 100..)
    through the video path, two frames a clip, cropped with
    `default_rng(7)` (`default_trunk_scales`, `esrgan_lite.py:784`)."""
    from nu_scaler_tpu_torch.models.data import clip_through_video_path, render_clip

    crops = []
    rng = np.random.default_rng(7)
    sc = model.upscale  # LR = HR / upscale, the serving input's domain
    # clips are 288×512: the crop capped so HR fits and LR stays stride-divisible
    lr_c = min(96, 288 // sc // model.stride * model.stride)
    hr_c = lr_c * sc
    for seed in range(100, 100 + n_clips):
        for f in clip_through_video_path(render_clip(seed=seed, frames=2)):
            y = rng.integers(0, f.shape[0] - hr_c + 1)
            x = rng.integers(0, f.shape[1] - hr_c + 1)
            hr = f[y: y + hr_c, x: x + hr_c, :3].astype(np.float32) / 255.0
            crops.append(hr.reshape(lr_c, sc, lr_c, sc, 3).mean(axis=(1, 3)))
    return calibrate_trunk_scales(model, np.stack(crops))
