"""Real-ESRGAN's RRDBNet, served as the learned tier's "realesrgan" ladder.

`RealESRGAN_x2plus` (https://github.com/xinntao/Real-ESRGAN,
arXiv:2107.10833) is `RRDBNet(num_in_ch=3, num_out_ch=3, num_feat=64,
num_block=23, num_grow_ch=32, scale=2)` of BasicSR's
`basicsr/archs/rrdbnet_arch.py`. On NCHW in [0, 1], with ``c`` a 3×3 SAME
conv with bias and ``lr`` LeakyReLU of slope 0.2:

- front end: ``f0 = c_first(pixel_unshuffle(x, 2))``, 12 → 64 channels, the
  channel order ``c·4 + dy·2 + dx`` of `F.pixel_unshuffle` (×4 reads the
  RGB planes as they are; ×1 unshuffles by 4);
- RDB(x): ``x1 = lr(c1(x))``, ``x2 = lr(c2([x, x1]))``, … ``x4``, reading
  64, 96, 128 and 160 channels and writing 32 each; ``x5 = c5([x, …, x4])``,
  192 → 64; it returns ``0.2·x5 + x``;
- RRDB(x) = ``0.2·RDB3(RDB2(RDB1(x))) + x``;
- body: ``f = f0 + c_body(RRDB_23(…RRDB_1(f0)))``;
- upsampling: ``f = lr(c_up1(nearest×2(f)))``, ``f = lr(c_up2(nearest×2(f)))``,
  then ``y = c_last(lr(c_hr(f)))``, 64 → 3.

`RRDBNet` holds the layers under BasicSR's parameter names, so a published
``params_ema`` state dict loads as it is. `RRDBServing` computes the
equations above, u8 RGBA [N, H, W, 4] → u8 RGBA [N, OH, OW, 4], as
Real-ESRGAN's `inference_realesrgan.py` runs it by default (``--tile 0``,
``--pre_pad 0``, half precision): RGB / 255 into fp16 (an odd side
reflect-padded to even and the output cropped back, as
`RealESRGANer.pre_process` does), every conv in fp16 at its real widths with
fp32 sums, then ``round(clamp(y, 0, 1)·255)`` to u8, half to even. A ratio
other than the model's resizes its output to the target
(`ops.image_resize`), as the learned tier's `UnfusedServing` does.
The alpha plane is resized on its own, as `UnfusedServing` resizes it, where
upstream runs a second upscaler (``--alpha_upsampler``); the links' frames
are opaque.

The dense connections live in growth buffers: one buffer of
``num_feat + 4·num_grow_ch`` channels (192) per RDB, whose first 64 channels
hold the RDB's input, channel-blocked (`rrdb_conv_cuda.blocked`: memory
``[N, C/8, H, W, 8]``, so that each row of an 8-channel plane that the
kernel loads is contiguous). Every conv of the body, `conv_body` and the
three upsampling convs run on `kernels/rrdb_conv_cuda.py` `rrdb_conv`
(`csrc/rrdb_conv.cu` on a card, its plain version on the CPU): conv k reads
the buffer's channel prefix in place and writes its 32 channels into their
slice, with the bias and LeakyReLU in its epilogue; conv5 reads all 192 and
writes ``x + 0.2·(c5 + b)`` into channels 0–63 of the next RDB's buffer, and
for an RRDB's third RDB ``x0 + 0.2·(x + 0.2·(c5 + b))``, the RRDB's residual
too; `conv_body` adds ``f0``. Three buffers rotate (RDB1 a → b, RDB2 b → c,
RDB3 c → a, where a holds the RRDB's input ``x0``), so nothing is
concatenated and no bias, activation or residual runs as a pass of its own.
Each conv's epilogue rounds once to fp16, where the library conv rounded its
sum and each later pass rounded again. `conv_first` (12 → 64) and
`conv_last` (64 → 3) stay on `F.conv2d` (cuDNN) with its bias, on NHWC:
`conv_first`'s output goes into buffer a by the copy that seeds it, and
`conv_body` adds it as an NHWC residual; `conv_body`, the nearest
upsampling (`upsample2x`, on the planes as a batch) and the first two
upsampling convs keep the blocked layout, and `conv_hr` writes NHWC for
`conv_last`.

Weights are the port's npz + JSON sidecar format (`esrgan_lite.read_weights`)
under BasicSR's names (OIHW), ``esrgan_rrdbnet_x{scale}_{step}.npz``, found
by `esrgan_lite.weights_directory` in the trainer's `CKPT_ROOT` or the
committed ``weights/``. Nothing is committed yet: the published
``RealESRGAN_x2plus.pth`` is not in the repository, so the ladder raises
ValueError until weights are written there (`write_weights`).

Spans (`utils.tracing`, off by default): ``nu.models.rrdb`` (the frame's
bytes) with ``.unshuffle``, ``.first``, ``.body`` (``.rrdb`` with its
``index``, then ``.conv_body``), ``.upsample`` (``.up1``, ``.up2``, ``.hr``,
``.last``) and ``.pack``; the kernel's own ``nu.kernels.rrdb_conv`` under
them. Counters: `launches` (``"rrdb_conv"``: calls of `rrdb_conv`, a launch
each on a card; ``"conv"``: `F.conv2d` calls), zeroed by `reset_launches()`;
the kernel's own (`rrdb_conv_cuda.launches`) counts its blocked inputs.
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.kernels.rrdb_conv_cuda import (Conv, blocked, channel_slice, channels, make_conv,
                                                        rrdb_conv, to_blocked, upsample2x)
from nu_scaler_tpu_torch.models import esrgan_lite
from nu_scaler_tpu_torch.ops.image_resize import image_resize
from nu_scaler_tpu_torch.utils.tracing import span

LADDER = "realesrgan"  # `learned_prefer` / `make_pretrained_upscaler`'s prefer
ARCH = "rrdbnet"  # the weights' arch name: esrgan_rrdbnet_x{scale}_{step}.npz
X2PLUS = dict(num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23, num_grow_ch=32, scale=2)
SLOPE = 0.2  # LeakyReLU's negative slope
RES = 0.2  # the RDB's and the RRDB's residual scale

# Since the last `reset_launches()`: `rrdb_conv` calls (a kernel launch each
# on a card) and `F.conv2d` calls.
launches = {"rrdb_conv": 0, "conv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32) -> None:
        super().__init__()
        for k in range(1, 5):
            setattr(self, f"conv{k}", _conv(num_feat + (k - 1) * num_grow_ch, num_grow_ch))
        self.conv5 = _conv(num_feat + 4 * num_grow_ch, num_feat)


class RRDB(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int = 32) -> None:
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)


class RRDBNet(nn.Module):
    """BasicSR's `RRDBNet`: its layers under its parameter names (a state
    dict loads as it is); `RRDBServing` runs them."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 23, num_grow_ch: int = 32, scale: int = 4) -> None:
        super().__init__()
        if scale not in (1, 2, 4):
            raise ValueError(f"RRDBNet serves x1, x2 or x4, not x{scale}")
        self.scale = scale
        self.unshuffle = {4: 1, 2: 2, 1: 4}[scale]
        self.conv_first = _conv(num_in_ch * self.unshuffle ** 2, num_feat)
        self.body = nn.Sequential(*(RRDB(num_feat, num_grow_ch) for _ in range(num_block)))
        self.conv_body = _conv(num_feat, num_feat)
        self.conv_up1 = _conv(num_feat, num_feat)
        self.conv_up2 = _conv(num_feat, num_feat)
        self.conv_hr = _conv(num_feat, num_feat)
        self.conv_last = _conv(num_feat, num_out_ch)


# ---------------------------------------------------------------------------
# weights: the port's npz + sidecar format under BasicSR's names
# ---------------------------------------------------------------------------


def npz_bytes(state: dict) -> bytes:
    """The npz of `state` (name → array, written as float32 in the dict's
    order), byte for byte the same for the same arrays: stored members with a
    fixed date, so its sha256 names the weights."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for name, arr in state.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, np.ascontiguousarray(arr, np.float32), version=(1, 0))
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = 0o644 << 16
            z.writestr(info, member.getvalue())
    return buf.getvalue()


def write_weights(directory: Path, state: dict, step: int, model: Optional[dict] = None,
                  **meta) -> Path:
    """``esrgan_rrdbnet_x{scale}_{step}.npz`` (`npz_bytes` of `state`, a
    BasicSR state dict of arrays or tensors) and its sidecar in `directory`:
    the arch, step, model widths (`X2PLUS` by default), parameter count, the
    npz's sha256 and `meta`. The sidecar is written last (the loaders glob
    for it). Returns the npz's path."""
    model = dict(X2PLUS if model is None else model)
    arrays = {k: (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
              for k, v in state.items()}
    blob = npz_bytes(arrays)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    stem = directory / f"esrgan_{ARCH}_x{model['scale']}_{step}"
    npz = stem.with_suffix(".npz")
    npz.write_bytes(blob)
    sidecar = {"arch": ARCH, "step": int(step), "model": model, **meta,
               "parameters": int(sum(a.size for a in arrays.values())),
               "sha256": hashlib.sha256(blob).hexdigest()}
    stem.with_suffix(".json").write_text(json.dumps(sidecar, indent=1) + "\n")
    return npz


@functools.lru_cache(maxsize=2)
def _load(directory: Path, step: int, sha256: str, scale: int) -> tuple[RRDBNet, dict]:
    with span("nu.setup.weights"):
        meta = json.loads((directory / f"esrgan_{ARCH}_x{scale}_{step}.json").read_text())
        tree = esrgan_lite.read_weights(directory / f"esrgan_{ARCH}_x{scale}_{step}.npz", sha256)
        model = RRDBNet(**meta["model"])
        model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in tree.items()})
    return model.eval(), meta


# ---------------------------------------------------------------------------
# the serving graph
# ---------------------------------------------------------------------------


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """An NCHW tensor as an NHWC view (channels-last memory, made so if it is
    not)."""
    return t.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as an NCHW view in channels-last memory."""
    return t.permute(0, 3, 1, 2)


class RRDBServing:
    """u8 RGBA [N, H, W, 4] → u8 RGBA [N, out_h, out_w, 4] through `model` in
    `dtype` (fp16 by default, the only one a card takes), NHWC; see the
    module's docstring."""

    def __init__(self, model: RRDBNet, in_h: int, in_w: int, out_h: int, out_w: int, device,
                 dtype: torch.dtype = torch.float16) -> None:
        self.device = resolve_device(device)
        self.in_hw, self.out_hw = (in_h, in_w), (out_h, out_w)
        self.scale, self.unshuffle, self.dtype = model.scale, model.unshuffle, dtype
        self.quantized = False  # `LearnedUpscaler` reports it: no int8 graph here

        def wb(c: nn.Conv2d) -> tuple[torch.Tensor, torch.Tensor]:
            w = c.weight.detach().to(self.device, dtype).contiguous(memory_format=torch.channels_last)
            return w, c.bias.detach().to(self.device, dtype)

        def kernel(c: nn.Conv2d) -> Conv:
            return make_conv(c.weight, c.bias, self.device, dtype)

        with span("nu.setup.weights"):
            self.first, self.last = wb(model.conv_first), wb(model.conv_last)
            self.rrdbs = [[[kernel(getattr(rdb, f"conv{k}")) for k in range(1, 6)]
                           for rdb in (blk.rdb1, blk.rdb2, blk.rdb3)] for blk in model.body]
            self.conv_body, self.up1, self.up2, self.hr = (
                kernel(c) for c in (model.conv_body, model.conv_up1, model.conv_up2, model.conv_hr))
        if self.device.type == "cuda":
            from nu_scaler_tpu_torch.kernels import _build

            _build.load_library("rrdb_conv")  # built and loaded in set-up, not at the first frame

    def _c(self, x: torch.Tensor, p: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        launches["conv"] += 1
        return F.conv2d(x, p[0], p[1], padding=1)

    def _k(self, src: torch.Tensor, conv: Conv, out: torch.Tensor, **epilogue) -> torch.Tensor:
        launches["rrdb_conv"] += 1
        return rrdb_conv(src, conv, out, **epilogue)

    def rdb(self, buf: torch.Tensor, convs: list, out: torch.Tensor,
            x0: Optional[torch.Tensor] = None) -> None:
        """One RDB on its blocked growth buffer `buf` (192 channels), whose
        first channels hold its input x: ``x_k = lr(c_k(buf[:64 + 32(k-1)]))``
        into channels ``64 + 32(k-1) ..``, then ``x + 0.2·c5(buf)`` into
        `out`, or ``x0 + 0.2·(x + 0.2·c5(buf))`` with `x0` (the RRDB's
        residual; `out` may be x0)."""
        lo = channels(out)
        for conv in convs[:4]:
            self._k(buf, conv, channel_slice(buf, lo, lo + conv.cout), slope=SLOPE)
            lo += conv.cout
        self._k(buf, convs[4], out, res=channel_slice(buf, 0, channels(out)), res_scale=RES, res2=x0,
                res2_scale=RES)

    def body(self, f0: torch.Tensor) -> torch.Tensor:
        """The RRDBs on `f0` [N, h, w, num_feat] (NHWC), ``x + 0.2·RDB3(RDB2(RDB1(x)))``
        each, over three blocked growth buffers; returns the first channels
        of the one that holds the result (blocked)."""
        n, h, w, c = f0.shape
        width = c + sum(conv.cout for conv in self.rrdbs[0][0][:4]) if self.rrdbs else c
        a, b, cc = (blocked(n, h, w, width, f0.dtype, f0.device) for _ in range(3))
        x0 = to_blocked(f0, out=channel_slice(a, 0, c))
        for i, rdbs in enumerate(self.rrdbs):
            with span("nu.models.rrdb.rrdb", index=i):
                self.rdb(a, rdbs[0], channel_slice(b, 0, c))
                self.rdb(b, rdbs[1], channel_slice(cc, 0, c))
                self.rdb(cc, rdbs[2], x0, x0)
        return x0

    def up(self, f: torch.Tensor, conv: Conv) -> torch.Tensor:
        """``lr(c(nearest×2(f)))`` on blocked `f`, blocked."""
        u = upsample2x(f)
        n, h, w, c = (*u.shape[:3], channels(u))
        return self._k(u, conv, blocked(n, h, w, c, u.dtype, u.device), slope=SLOPE)

    # -- the frame ----------------------------------------------------------

    def net(self, x: torch.Tensor) -> torch.Tensor:
        """The model on x [N, 3, H, W] in `dtype` (H, W even at ×2) →
        [N, 3, sH, sW] in `dtype`."""
        with span("nu.models.rrdb.first"):
            f0 = _nhwc(self._c(x, self.first))
        with span("nu.models.rrdb.body"):
            trunk = self.body(f0)
            with span("nu.models.rrdb.conv_body"):
                f = self._k(trunk, self.conv_body, blocked(*f0.shape, f0.dtype, f0.device), res=f0)
            del trunk, f0  # the growth buffers go before the 4K stages
        with span("nu.models.rrdb.upsample"):
            with span("nu.models.rrdb.up1"):
                f = self.up(f, self.up1)
            with span("nu.models.rrdb.up2"):
                f = self.up(f, self.up2)
            with span("nu.models.rrdb.hr"):
                n, h, w, c = (*f.shape[:3], channels(f))
                f = self._k(f, self.hr, torch.empty((n, h, w, c), dtype=f.dtype, device=f.device),
                            slope=SLOPE)
            with span("nu.models.rrdb.last"):
                return self._c(_nchw(f), self.last)

    def prepare(self, img: torch.Tensor) -> torch.Tensor:
        """u8 RGBA [N, H, W, 4] → the net's input in `dtype`: RGB / 255, an
        odd side reflect-padded to even (RealESRGANer's mod pad), pixel
        unshuffled (channel ``c·4 + dy·2 + dx`` at ×2)."""
        h, w = img.shape[1], img.shape[2]
        x = (img[..., :3].permute(0, 3, 1, 2).float() / 255.0).to(self.dtype)
        m = self.unshuffle
        ph, pw = -h % m, -w % m
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        if m > 1:
            x = F.pixel_unshuffle(x, m)
        return x.contiguous(memory_format=torch.channels_last)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if tuple(img.shape[1:3]) != self.in_hw or img.shape[3] != 4 or img.dtype != torch.uint8:
            raise ValueError(f"expected u8 [N, {self.in_hw[0]}, {self.in_hw[1]}, 4], "
                             f"got {img.dtype} {tuple(img.shape)}")
        n, (h, w) = img.shape[0], self.in_hw
        with span("nu.models.rrdb", bytes=img):
            with span("nu.models.rrdb.unshuffle"):
                x = self.prepare(img)
            y = self.net(x)
            with span("nu.models.rrdb.pack"):
                s = self.scale
                rgb = y[:, :, : h * s, : w * s].float().permute(0, 2, 3, 1)
                if (h * s, w * s) != self.out_hw:
                    rgb = image_resize(rgb, (n, *self.out_hw, 3))
                rgb = torch.round(rgb.clamp(0.0, 1.0) * 255.0)
                alpha = image_resize(img[..., 3:].float() * esrgan_lite.INV_255, (n, *self.out_hw, 1))
                alpha = torch.clamp(torch.round(alpha * 255.0), 0, 255)
                return torch.cat([rgb, alpha], dim=-1).to(torch.uint8)


@functools.lru_cache(maxsize=4)
def _build(in_h, in_w, out_h, out_w, device, directory, step, sha256, scale):
    model, meta = _load(directory, step, sha256, scale)
    serving = RRDBServing(model, in_h, in_w, out_h, out_w, device)
    return esrgan_lite.LearnedUpscaler(serving, ARCH, meta["step"], directory)


def make_upscaler(in_h: int, in_w: int, out_h: int, out_w: int, device=None) -> esrgan_lite.LearnedUpscaler:
    """The "realesrgan" ladder: RRDBNet ×2 from the newest weights that serve
    (the trainer's `CKPT_ROOT`, else the committed ``weights/``), fp16, as a
    `LearnedUpscaler` (``arch`` "rrdbnet"). Cached per sizes, device and
    weights. With no such weights it raises ValueError: no other model
    stands in."""
    directory = esrgan_lite.weights_directory(ARCH, X2PLUS["scale"])
    if directory is None:
        raise ValueError(f"no {ARCH} x{X2PLUS['scale']} weights serve the {LADDER!r} ladder: write "
                         f"them with rrdbnet.write_weights into the trainer's CKPT_ROOT")
    meta = esrgan_lite.newest_sidecar(directory, f"esrgan_{ARCH}_x{X2PLUS['scale']}_*.json")
    return _build(in_h, in_w, out_h, out_w, resolve_device(device), Path(directory), meta["step"],
                  meta["sha256"], X2PLUS["scale"])
