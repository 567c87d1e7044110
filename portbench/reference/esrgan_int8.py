"""Plain reference of the learned "quality" ×2 tier: the s2d ESRGAN-lite
graph of the committed checkpoint on the int8 grid, in plain PyTorch.

The graph, on u8 RGBA [H, W, 4] (raw 0..255, alpha included):

- s2d at the stride: [h, w, st²·4], channel qy·st·4 + qx·4 + c.
- Every conv is a 3x3 conv on the int8 grid: the kernel quantised per output
  channel (kq = round(k / s), s = max|k| / 127; for the base, s renormalised
  so the quantised taps keep the kernel's sum), the input quantised as
  clamp(round(x · f32(127 / ax)), −127, 127) with the checkpoint's
  activation scale ax; the integer conv (zero padding, SAME), times the
  dequantisation f32(s) · f32(ax / 127), plus the fp32 bias, each rounded in
  fp32; ReLU where the block says; one rounding to bf16.
- head: the RGB rows of the s2d (the weights times 1/255, alpha rows zero),
  ax = 255 · scale["head"] → feat.
- each block: h + bf16(0.2) · conv2(relu(conv1(h))), in bf16.
- trunk: conv(h) + feat, in bf16.
- tail: to the RGBA phases (RGB weights and bias times 255, alpha zero).
- base: the fixed bilinear base kernel on the edge-padded s2d (VALID),
  ax = 255 · scale["base"], no bias.
- out: clamp(round(tail + base)) to u8 (bf16 sum), depth to space.

The integer convs run as `F.conv2d` in float64 with TF32 off: every partial
sum of integer products is exact there, as it is in the kernel's fp32 below
2^24. `qmax` 127 is the reference; 7 (the int4 grid) its control.

It reads the npz and its JSON sidecar itself and imports nothing of the
program.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def read_checkpoint(npz: Path, sidecar: Path) -> tuple[dict, dict]:
    """(the npz's arrays by flax name, the sidecar) after checking the npz's
    sha256 against the sidecar's."""
    meta = json.loads(sidecar.read_text())
    digest = hashlib.sha256(npz.read_bytes()).hexdigest()
    if digest != meta["sha256"]:
        raise ValueError(f"{npz.name}: sha256 {digest} != its sidecar's {meta['sha256']}")
    with np.load(npz) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}, meta


def bilinear_base_kernel(c: int, upscale: int, stride: int) -> np.ndarray:
    """HWIO 3x3 kernel from the s2d(`stride`) tensor to the phases of the
    half-pixel-centre bilinear upscale: output phase (py, px) of a cell
    samples input coordinate stride·I + (p + 0.5)/upscale − 0.5, whose two
    taps per axis lie in the cell's 3x3 neighbourhood."""
    s, r = stride, stride * upscale
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
                for n, wx in ((n0, 1.0 - fx), (n0 + 1, fx)):
                    for ch in range(c):
                        k[m // s + 1, n // s + 1, (m % s) * s * c + (n % s) * c + ch,
                          py * r * c + px * c + ch] += wy * wx
    return k


def quant_kernel(k: np.ndarray, qmax: int, keep_sum: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(integer kernel, float32 scale per output channel) on the grid ±qmax."""
    amax = np.max(np.abs(k), axis=(0, 1, 2))
    s = np.where(amax > 0, amax / float(qmax), 1.0).astype(np.float32)
    kq = np.clip(np.round(k / s), -qmax, qmax).astype(np.float32)
    if keep_sum:
        qsum = kq.astype(np.float64).sum(axis=(0, 1, 2))
        osum = k.astype(np.float64).sum(axis=(0, 1, 2))
        s = np.where(qsum != 0, osum / np.where(qsum == 0, 1, qsum), s).astype(np.float32)
    return kq, s


def s2d(x: torch.Tensor, st: int) -> torch.Tensor:
    h, w, c = x.shape
    return x.reshape(h // st, st, w // st, st, c).permute(0, 2, 1, 3, 4).reshape(h // st, w // st, st * st * c)


def d2s(x: torch.Tensor, r: int) -> torch.Tensor:
    h, w, rrc = x.shape
    c = rrc // (r * r)
    return x.reshape(h, w, r, r, c).permute(0, 2, 1, 3, 4).reshape(h * r, w * r, c)


class QConv:
    """One conv on the grid ±qmax, input scale `ax`."""

    def __init__(self, k: np.ndarray, b, ax: float, qmax: int, device, keep_sum: bool = False) -> None:
        kq, s = quant_kernel(k, qmax, keep_sum)
        self.qmax = qmax
        self.inv = torch.tensor(float(qmax) / ax, dtype=torch.float32, device=device)
        self.k = torch.from_numpy(kq).permute(3, 2, 0, 1).contiguous().to(device, torch.float64)  # OIHW
        deq = torch.from_numpy(s) * torch.tensor(ax / float(qmax), dtype=torch.float32)
        self.scale = deq.to(device)
        self.b = None if b is None else torch.from_numpy(np.asarray(b, np.float32)).to(device)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x.float() * self.inv), -self.qmax, self.qmax)

    def conv(self, xq: torch.Tensor, pad: str = "zeros", relu: bool = False) -> torch.Tensor:
        """xq [h, w, C] on the grid → bf16 [h, w, Cout]; `pad` "edge" runs the
        conv VALID on the edge-padded input."""
        x = xq.permute(2, 0, 1)[None].to(torch.float64)
        if pad == "edge":
            x = F.pad(x, (1, 1, 1, 1), mode="replicate")
            acc = F.conv2d(x, self.k)
        else:
            acc = F.conv2d(x, self.k, padding=1)
        acc = torch.round(acc)[0].permute(1, 2, 0).to(torch.float32) * self.scale  # exact integer sums
        if self.b is not None:
            acc = acc + self.b
        if relu:
            acc = torch.clamp_min(acc, 0.0)
        return acc.to(torch.bfloat16)

    def __call__(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return self.conv(self.quantize(x), relu=relu)


class Int8Graph:
    """The tpu4b2-style graph (any stride, features, blocks, ×upscale) of one
    checkpoint on the grid ±qmax: u8 RGBA [H, W, 4] → u8 RGBA [uH, uW, 4]."""

    def __init__(self, params: dict, scales: dict, cfg: dict, device, qmax: int = 127) -> None:
        st, up = cfg["stride"], cfg["upscale"]
        self.st, self.r = st, st * up
        p = params
        head = np.zeros((3, 3, st * st * 4, cfg["features"]), np.float32)
        for q in range(st * st):
            head[:, :, q * 4:q * 4 + 3, :] = p["head/kernel"][:, :, q * 3:q * 3 + 3, :] * (1 / 255.0)
        self.head = QConv(head, p["head/bias"], 255.0 * scales["head"], qmax, device)
        self.blocks = [(QConv(p[f"block{i}/conv1/kernel"], p[f"block{i}/conv1/bias"],
                              scales[f"block{i}/conv1"], qmax, device),
                        QConv(p[f"block{i}/conv2/kernel"], p[f"block{i}/conv2/bias"],
                              scales[f"block{i}/conv2"], qmax, device))
                       for i in range(cfg["blocks"])]
        self.trunk = QConv(p["trunk/kernel"], p["trunk/bias"], scales["trunk"], qmax, device)
        r = self.r
        tk, tb = p["tail/kernel"], p["tail/bias"]
        tail = np.zeros((3, 3, tk.shape[2], r * r * 4), np.float32)
        tail_b = np.zeros((r * r * 4,), np.float32)
        for ph in range(r * r):
            tail[:, :, :, ph * 4:ph * 4 + 3] = tk[:, :, :, ph * 3:ph * 3 + 3] * 255.0
            tail_b[ph * 4:ph * 4 + 3] = tb[ph * 3:ph * 3 + 3] * 255.0
        self.tail = QConv(tail, tail_b, scales["tail"], qmax, device)
        self.base = QConv(bilinear_base_kernel(4, up, st), None, 255.0 * scales["base"], qmax, device,
                          keep_sum=True)
        self.c02 = torch.tensor(0.2, dtype=torch.bfloat16, device=device)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        x = s2d(img.to(torch.float32), self.st)
        feat = self.head(x)
        h = feat
        for c1, c2 in self.blocks:
            h = h + self.c02 * c2(c1(h, relu=True))
        h = self.trunk(h) + feat
        tail = self.tail(h)
        base = self.base.conv(self.base.quantize(x), pad="edge")
        phases = tail + base
        return d2s(torch.clamp(torch.round(phases), 0, 255).to(torch.uint8), self.r)


class Reference:
    """The learned configuration's reference: an input frame's payload is its
    upscale. `control` runs the graph on the int4 grid."""

    def __init__(self, cfg: dict, device, control: bool = False) -> None:
        root = Path(__file__).resolve().parents[2]
        params, meta = read_checkpoint(root / cfg["weights"], root / cfg["sidecar"])
        if meta["sha256"] != cfg["sha256"] or meta["step"] != cfg["step"]:
            raise ValueError(f"{cfg['weights']}: step {meta['step']} sha256 {meta['sha256']} "
                             f"are not the configuration's")
        self.graph = Int8Graph(params, meta["act_scales"]["scales"], cfg, device, 7 if control else 127)

    def upscale(self, cur: torch.Tensor) -> torch.Tensor:
        return self.graph(cur)

    def payloads(self, prev_up, up: torch.Tensor) -> list[torch.Tensor]:
        """A frame's payload: its upscale."""
        return [up]

    def step_fn(self):
        """The reference in the program's place, as the pipeline's upscale."""
        return {"upscale_fn": self.graph}
