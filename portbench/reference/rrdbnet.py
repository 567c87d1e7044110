"""Plain reference of the "realesrgan" ladder: BasicSR's RRDBNet forward
(`basicsr/archs/rrdbnet_arch.py`) as Real-ESRGAN's `inference_realesrgan.py`
frames it, in float32 with TF32 off, on u8 RGBA [H, W, 4]:

- RGB / 255; ``pixel_unshuffle`` by 2; ``conv_first``; 23 RRDBs, each
  ``0.2·RDB3(RDB2(RDB1(x))) + x``, an RDB ``0.2·c5([x, x1..x4]) + x`` with
  ``x_k = lrelu(c_k([x, x1..x_{k-1}]))`` (`torch.cat` of every prefix);
  ``+ conv_body``; two nearest ×2 + conv + LeakyReLU; ``conv_hr`` +
  LeakyReLU; ``conv_last``; ``round(clamp(y, 0, 1)·255)`` to u8;
- alpha: bilinear ×2 (half-pixel centres) of alpha / 255, rounded.

Its control is the same graph with the weights and every activation rounded
to bfloat16, one precision below the configuration's fp16.

The weights are the configuration's seeded ones, drawn here by a plain numpy
generator from ``weights_seed`` (`seeded_state`) under BasicSR's names, and
written in the port's npz + sidecar format (`write_checkpoint`), whose npz
sha256 the configuration pins. It imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import io
import json
import zipfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Planted faults (the benchmark's tests): where one sits, the 12th RRDB's second RDB.
FAULTS = ("skip_rrdb", "slope_zero", "concat_permuted", "residual_quarter", "bilinear_upsampling")
FAULT_RRDB, FAULT_RDB = 11, 2


def conv_shapes(cfg: dict) -> list[tuple[str, int, int]]:
    """(BasicSR name, Cin, Cout) of every conv, in the state dict's order."""
    f, g, s = cfg["num_feat"], cfg["num_grow_ch"], cfg["scale"]
    unshuffle = {4: 1, 2: 2, 1: 4}[s]
    out = [("conv_first", cfg["num_in_ch"] * unshuffle ** 2, f)]
    for i in range(cfg["num_block"]):
        for j in (1, 2, 3):
            out += [(f"body.{i}.rdb{j}.conv{k}", f + (k - 1) * g, g) for k in range(1, 5)]
            out.append((f"body.{i}.rdb{j}.conv5", f + 4 * g, f))
    out += [(n, f, f) for n in ("conv_body", "conv_up1", "conv_up2", "conv_hr")]
    out.append(("conv_last", f, cfg["num_out_ch"]))
    return out


def seeded_state(cfg: dict) -> dict[str, np.ndarray]:
    """The configuration's weights, from ``weights_seed`` and its ``init``:
    BasicSR's init, each conv drawn in order from one numpy generator. The
    dense blocks' convs Kaiming normal (fan in, gain √2) times
    ``init["rdb_scale"]``, bias 0 (BasicSR's `default_init_weights`); every
    other conv PyTorch's `nn.Conv2d` default, weight and bias uniform in
    ±1/√fan_in; then ``conv_last``'s weight times ``init["conv_last_scale"]``
    and its bias set to ``init["conv_last_bias"]``."""
    init = cfg["init"]
    rng = np.random.default_rng(int(cfg["weights_seed"]))
    state = {}
    for name, cin, cout in conv_shapes(cfg):
        fan_in = cin * 9
        if name.startswith("body."):
            w = rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / fan_in) * init["rdb_scale"]
            b = np.zeros(cout)
        else:
            bound = 1.0 / np.sqrt(fan_in)
            w = rng.uniform(-bound, bound, (cout, cin, 3, 3))
            b = rng.uniform(-bound, bound, cout)
        if name == "conv_last":
            w, b = w * init["conv_last_scale"], np.full(cout, init["conv_last_bias"])
        state[f"{name}.weight"], state[f"{name}.bias"] = w.astype(np.float32), b.astype(np.float32)
    return state


def npz_bytes(state: dict) -> bytes:
    """The port's npz of `state`: stored .npy members in order, with a fixed
    date, so the same arrays give the same bytes."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for name, arr in state.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, np.ascontiguousarray(arr, np.float32), version=(1, 0))
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = 0o644 << 16
            z.writestr(info, member.getvalue())
    return buf.getvalue()


def write_checkpoint(state: dict, directory: Path, cfg: dict) -> Path:
    """``esrgan_{arch}_x{scale}_{step}.npz`` and its sidecar in `directory`,
    the sidecar last. Returns the npz's path."""
    blob = npz_bytes(state)
    stem = Path(directory) / f"esrgan_{cfg['arch']}_x{cfg['scale']}_{cfg['step']}"
    npz = stem.with_suffix(".npz")
    npz.write_bytes(blob)
    model = {k: cfg[k] for k in ("num_in_ch", "num_out_ch", "num_feat", "num_block", "num_grow_ch", "scale")}
    meta = {"arch": cfg["arch"], "step": cfg["step"], "model": model, "weights_seed": cfg["weights_seed"],
            "parameters": int(sum(a.size for a in state.values())),
            "sha256": hashlib.sha256(blob).hexdigest()}
    stem.with_suffix(".json").write_text(json.dumps(meta, indent=1) + "\n")
    return npz


def _c(x, p, name):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], padding=1)


def _rdb(x, p, name, fault):
    hit = name == f"body.{FAULT_RRDB}.rdb{FAULT_RDB}"
    slope = 0.0 if hit and fault == "slope_zero" else 0.2
    feats = [x]
    for k in range(1, 5):
        feats.append(F.leaky_relu(_c(torch.cat(feats, 1), p, f"{name}.conv{k}"), slope))
    if hit and fault == "concat_permuted":
        feats = [feats[0], feats[1], feats[2], feats[4], feats[3]]
    scale = 0.25 if hit and fault == "residual_quarter" else 0.2
    return _c(torch.cat(feats, 1), p, f"{name}.conv5") * scale + x


def net(x, p, num_block: int, fault=None):
    """x [1, 3, H, W] in [0, 1] → [1, 3, 2H, 2W], in x's dtype."""
    if fault == "bilinear_upsampling":
        up = lambda t: F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False)  # noqa: E731
    else:
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
    feat = _c(F.pixel_unshuffle(x, 2), p, "conv_first")
    body = feat
    for i in range(num_block):
        if i == FAULT_RRDB and fault == "skip_rrdb":
            continue
        out = body
        for j in (1, 2, 3):
            out = _rdb(out, p, f"body.{i}.rdb{j}", fault)
        body = out * 0.2 + body
    feat = feat + _c(body, p, "conv_body")
    feat = F.leaky_relu(_c(up(feat), p, "conv_up1"), 0.2)
    feat = F.leaky_relu(_c(up(feat), p, "conv_up2"), 0.2)
    return _c(F.leaky_relu(_c(feat, p, "conv_hr"), 0.2), p, "conv_last")


class NoTF32:
    """cuDNN's convs and cuBLAS's matmuls in full fp32 inside the block (each
    backend's own switch, restored after)."""

    def __enter__(self):
        self.old = (torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision)
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision = self.old
        return False


class Graph:
    """u8 RGBA [H, W, 4] → u8 RGBA [2H, 2W, 4] in `dtype`, with `fault`."""

    def __init__(self, state: dict, cfg: dict, device, dtype=torch.float32, fault=None) -> None:
        self.p = {k: torch.from_numpy(v).to(device, dtype) for k, v in state.items()}
        self.num_block, self.dtype, self.fault = cfg["num_block"], dtype, fault

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        h, w = img.shape[0], img.shape[1]
        x = (img[..., :3].permute(2, 0, 1)[None].float() / 255.0).to(self.dtype)
        with torch.no_grad(), NoTF32():
            y = net(x, self.p, self.num_block, self.fault)
        rgb = torch.round(y[0].float().clamp(0.0, 1.0) * 255.0).permute(1, 2, 0)
        a = img[..., 3].float()[None, None] * (1.0 / 255.0)
        a = F.interpolate(a, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)[0, 0]
        a = torch.clamp(torch.round(a * 255.0), 0, 255)
        return torch.cat([rgb, a[..., None]], dim=-1).to(torch.uint8)


class Reference:
    """The configuration's reference: an input frame's payload is its
    upscale. `control` runs the graph in bfloat16; `fault` plants one of
    `FAULTS` (in the configuration's fp16)."""

    def __init__(self, cfg: dict, device, control: bool = False, fault=None) -> None:
        state = seeded_state(cfg)
        digest = hashlib.sha256(npz_bytes(state)).hexdigest()
        if digest != cfg["sha256"]:
            raise ValueError(f"the seeded weights have sha256 {digest}, not the configuration's {cfg['sha256']}")
        dtype = torch.bfloat16 if control else torch.float16 if fault else torch.float32
        self.graph = Graph(state, cfg, device, dtype, fault)

    def upscale(self, cur: torch.Tensor) -> torch.Tensor:
        return self.graph(cur)

    def payloads(self, prev_up, up: torch.Tensor) -> list[torch.Tensor]:
        """A frame's payload: its upscale."""
        return [up]

    def step_fn(self):
        """The reference in the program's place, as the pipeline's upscale."""
        return {"upscale_fn": self.graph}
