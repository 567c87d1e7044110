"""The plain reference of `models/rrdbnet.py`: BasicSR's RRDBNet forward
(`basicsr/archs/rrdbnet_arch.py`) in float32, as Real-ESRGAN's
`inference_realesrgan.py` frames it (``--fp32``, ``--tile 0``,
``--pre_pad 0``), on u8 RGBA.

It imports only `torch`: `F.pixel_unshuffle`, `torch.cat` of every prefix,
`F.interpolate(mode="nearest")`, one frame at a time, no kernels, buffers or
batching. TF32 is off while it runs (cuDNN's convs and cuBLAS's matmuls in
full fp32, each backend's own switch, restored after). The alpha plane is
resized on its own by `F.interpolate` bilinear (half-pixel centres), which at
×2 is the serving graph's `image_resize`.

`params` is a BasicSR state dict (name → tensor, OIHW), `num_block` RRDBs;
faults for the tests' planted-fault checks are named in `fault`.
"""

import torch
import torch.nn.functional as F

FAULTS = ("skip_rrdb", "slope_zero", "concat_permuted", "residual_quarter", "bilinear_upsampling")
FAULT_RRDB, FAULT_RDB = 11, 2  # where a planted fault sits: the 12th RRDB's second RDB


def _c(x, params, name):
    return F.conv2d(x, params[f"{name}.weight"], params[f"{name}.bias"], padding=1)


def _rdb(x, params, name, fault):
    hit = name == f"body.{FAULT_RRDB}.rdb{FAULT_RDB}"
    slope = 0.0 if hit and fault == "slope_zero" else 0.2
    feats = [x]
    for k in range(1, 5):
        feats.append(F.leaky_relu(_c(torch.cat(feats, 1), params, f"{name}.conv{k}"), slope))
    if hit and fault == "concat_permuted":
        feats = [feats[0], feats[1], feats[2], feats[4], feats[3]]
    scale = 0.25 if hit and fault == "residual_quarter" else 0.2
    return _c(torch.cat(feats, 1), params, f"{name}.conv5") * scale + x


def net(x, params, num_block, fault=None):
    """x [N, 3, H, W] in [0, 1], H and W even → [N, 3, 2H, 2W], in x's dtype."""
    mode = "bilinear" if fault == "bilinear_upsampling" else "nearest"

    def up(t):
        if mode == "nearest":
            return F.interpolate(t, scale_factor=2, mode="nearest")
        return F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False)

    feat = _c(F.pixel_unshuffle(x, 2), params, "conv_first")
    body = feat
    for i in range(num_block):
        if i == FAULT_RRDB and fault == "skip_rrdb":
            continue
        out = body
        for j in (1, 2, 3):
            out = _rdb(out, params, f"body.{i}.rdb{j}", fault)
        body = out * 0.2 + body
    feat = feat + _c(body, params, "conv_body")
    feat = F.leaky_relu(_c(up(feat), params, "conv_up1"), 0.2)
    feat = F.leaky_relu(_c(up(feat), params, "conv_up2"), 0.2)
    return _c(F.leaky_relu(_c(feat, params, "conv_hr"), 0.2), params, "conv_last")


class NoTF32:
    """TF32 off for cuDNN's convs and cuBLAS's matmuls inside the block."""

    def __enter__(self):
        self.old = (torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision)
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision = self.old
        return False


def upscale(img, params, num_block=23, fault=None, dtype=torch.float32):
    """u8 RGBA [H, W, 4] (H, W even) → u8 RGBA [2H, 2W, 4]: RGB / 255 in
    `dtype`, the net, ``round(clamp(y, 0, 1)·255)``; alpha bilinear ×2."""
    h, w = img.shape[0], img.shape[1]
    x = (img[..., :3].permute(2, 0, 1)[None].float() / 255.0).to(dtype)
    p = {k: v.to(img.device, dtype) for k, v in params.items()}
    with torch.no_grad(), NoTF32():
        y = net(x, p, num_block, fault)
    rgb = torch.round(y[0].float().clamp(0.0, 1.0) * 255.0).permute(1, 2, 0)
    a = img[..., 3].float()[None, None] * (1.0 / 255.0)
    a = F.interpolate(a, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)[0, 0]
    a = torch.clamp(torch.round(a * 255.0), 0, 255)
    return torch.cat([rgb, a[..., None]], dim=-1).to(torch.uint8)
