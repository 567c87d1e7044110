"""Wrapper of RRDBNet's dense-block conv kernel (`csrc/rrdb_conv.cu`) and its
plain PyTorch version.

`rrdb_conv` is a 3×3 SAME (zero padding) conv in fp16 with fp32 sums that
reads its input as the channel prefix of a tensor in place, and writes its
Cout (32 or 64) channels into `out`, a channel slice of another tensor, after
an epilogue in fp32 with one rounding at the end:

    v = conv(src[..., :Cin]) + bias
    v = lrelu(v, slope)            if slope is given
    v = res + res_scale · v        if res is given
    v = res2 + res2_scale · v      if res2 is given
    out = v (rounded to out's dtype)

each multiply and add rounded in fp32. `models/rrdbnet.py` `RRDBServing`
runs every conv of its 23 RRDBs, `conv_body` and the upsampling convs on it,
over one growth buffer per RDB (PERF.md §5). It replaces no TPU kernel: the
JAX package has no RRDBNet; it replaces cuDNN there.

Each operand is in one of two layouts, which its strides tell: NHWC
``[N, H, W, C]``, or channel-blocked, memory ``[N, C/8, H, W, 8]`` given as
its permuted view ``[N, H, W, C/8, 8]`` (`blocked`, `to_blocked`), so that a channel
slice of 8-channel blocks is a slice of the fourth dimension
(`channel_slice`), and the nearest ×2 upsampling keeps it (`upsample2x`).
Blocked, a row of one 8-channel plane is contiguous, so the kernel loads each
halo row as one run; `RRDBServing` holds its buffers so. No option picks the
layout: the kernel reads each operand's image, plane and position strides
(`strides`), and refuses any other layout or a slice that is not 8-aligned.

The weights are packed once (`make_conv`): the OIHW weight for the plain
version and the kernel's image ``[Cin/16, 9, 2, Cout, 8]`` (`pack_weights`:
16-channel chunks, tap by tap, 8 channels of every output channel a row),
which the kernel copies into shared memory a chunk at a time. A wrapper given
CPU tensors runs the plain version (any float dtype, any epilogue); given
CUDA tensors it launches the kernel (fp16, the epilogues of `EPILOGUES`) or
raises.

The plain version computes the sums in full fp32 (`conv_cuda.conv3x3_f32`:
nine tap matmuls, no TF32) and the epilogue with the same operations, so the
kernel (warpgroup MMAs, chunk by chunk and tap by tap) differs only by the
order and the rounding of its fp32 sums (the tensor cores' adds lean
towards smaller magnitudes, as cuDNN's convs do): within one fp16 ulp of the
result, or where the sum cancels, a small multiple of the fp32 rounding of
its terms (`ulp_tolerance`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from nu_scaler_tpu_torch.kernels.conv_cuda import conv3x3_f32
from nu_scaler_tpu_torch.utils.tracing import span

# Launches since the last `reset_launches()`; the wrapper adds one where it
# launches its kernel and nowhere else: "rrdb_conv" every launch, "blocked"
# those whose src is channel-blocked.
launches = {"rrdb_conv": 0, "blocked": 0}

CHUNK = 16  # Cin must be a multiple of this (the kernel's channel chunk)
# The kernel's epilogues, (Cout, LeakyReLU, residuals), as RRDBNet uses them:
# conv1-4 and the upsampling convs, conv5 and conv_body, an RRDB's last conv5.
EPILOGUES = ((32, True, 0), (64, True, 0), (64, False, 1), (64, False, 2))
CANCEL_REL = 2.0 ** -20  # the cancellation term of the tolerance (see conv_cuda)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@dataclass(frozen=True)
class Conv:
    """One 3×3 conv as the wrapper takes it: the OIHW `weight` (the serving
    dtype), the bias in fp32, and on a card the kernel's packed image."""

    weight: torch.Tensor
    bias: torch.Tensor
    packed: Optional[torch.Tensor]

    @property
    def cin(self) -> int:
        return self.weight.shape[1]

    @property
    def cout(self) -> int:
        return self.weight.shape[0]


def pack_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Cout, Cin, 3, 3]`` → ``[Cin/16, 9, 2, Cout, 8]``, contiguous:
    ``packed[q, 3·dy + dx, g, o, e] == weight[o, 16q + 8g + e, dy, dx]``."""
    cout, cin = weight.shape[:2]
    if cin % CHUNK or weight.shape[2:] != (3, 3):
        raise ValueError(f"expected OIHW [Cout, 16k, 3, 3], got {tuple(weight.shape)}")
    return weight.reshape(cout, cin // CHUNK, 2, 8, 9).permute(1, 4, 2, 0, 3).contiguous()


def make_conv(weight: torch.Tensor, bias: torch.Tensor, device, dtype: torch.dtype) -> Conv:
    """A conv's operands on `device`: the weight in `dtype`, the bias (as
    `dtype` holds it) in fp32, and on a card the packed image."""
    device = torch.device(device)
    wt = weight.detach().to(device, dtype).contiguous()
    b = bias.detach().to(device, dtype).float()
    return Conv(wt, b, pack_weights(wt) if device.type == "cuda" else None)


# ---------------------------------------------------------------------------
# the two layouts
# ---------------------------------------------------------------------------

BLOCK = 8  # channels of a plane of the blocked layout


def blocked(n: int, h: int, w: int, c: int, dtype: torch.dtype, device) -> torch.Tensor:
    """An uninitialised tensor of `c` channels (a multiple of 8), memory
    ``[N, C/8, H, W, 8]``, as its view ``[N, H, W, C/8, 8]``."""
    if c % BLOCK:
        raise ValueError(f"a blocked tensor holds channels in blocks of {BLOCK}, not {c}")
    return torch.empty((n, c // BLOCK, h, w, BLOCK), dtype=dtype, device=device).permute(0, 2, 3, 1, 4)


def to_blocked(t: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC `t` copied into `out`, a blocked tensor or channel slice of its
    shape (a new one if not given); returns `out`."""
    if out is None:
        out = blocked(*t.shape, t.dtype, t.device)
    out.copy_(t.unflatten(-1, (-1, BLOCK)))
    return out


def to_nhwc(t: torch.Tensor) -> torch.Tensor:
    """`t` as ``[N, H, W, C]``: itself if NHWC, a contiguous copy if blocked."""
    return t if t.dim() == 4 else t.flatten(3)


def upsample2x(t: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 of a whole blocked tensor, blocked: one `F.interpolate` on
    its planes seen as a batch, ``[N·C/8, 8, H, W]`` in channels-last
    memory."""
    n, h, w, p, _ = t.shape
    planes = t.permute(0, 3, 1, 2, 4).reshape(n * p, h, w, BLOCK)
    if planes.data_ptr() != t.data_ptr():
        raise ValueError("upsample2x takes a whole blocked tensor, not a slice")
    u = F.interpolate(planes.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    u = u.permute(0, 2, 3, 1)  # [N·C/8, 2H, 2W, 8], contiguous from a channels-last result
    return u.reshape(n, p, 2 * h, 2 * w, BLOCK).permute(0, 2, 3, 1, 4)


def channels(t: torch.Tensor) -> int:
    """The channels of an NHWC or blocked tensor."""
    return t.shape[3] if t.dim() == 4 else t.shape[3] * t.shape[4]


def channel_slice(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Channels ``lo .. hi - 1`` of `t` as a view in its layout (8-aligned
    when blocked)."""
    if t.dim() == 4:
        return t[..., lo:hi]
    if lo % BLOCK or hi % BLOCK:
        raise ValueError(f"a blocked tensor slices whole blocks of {BLOCK} channels, not {lo}:{hi}")
    return t[..., lo // BLOCK:hi // BLOCK, :]


def strides(name: str, t: torch.Tensor) -> tuple[int, int, int]:
    """The kernel's (image, plane, position) strides of `t` in elements: an
    NHWC view with contiguous channels and evenly spaced positions (a
    channel slice of an NHWC tensor), ``(·, 8, C)``, or a blocked view
    (`blocked`, or a slice of one), ``(·, H·W·8, 8)``; its first channel
    16-byte aligned; the image stride 0 for one image, else past the image
    and under 2³¹. Raises for any other layout."""
    s, dims = t.stride(), t.dim()
    ok = dims in (4, 5) and t.data_ptr() % 16 == 0
    if ok and dims == 4:
        n, h, w, c = t.shape
        img, plane, pos = s[0], BLOCK, s[2]
        ok = s[3] == 1 and c % BLOCK == 0 and pos % BLOCK == 0 and pos >= c and s[1] == w * pos
    elif ok:
        n, h, w, p, e = t.shape
        c, img, plane, pos = p * e, s[0], s[3], s[2]
        ok = (e == BLOCK and s[4] == 1 and pos == BLOCK and s[1] == w * BLOCK and plane >= h * w * BLOCK
              and plane % BLOCK == 0)
    if ok:
        extent = (h * w - 1) * pos + (c // BLOCK - 1) * plane + BLOCK
        img = img if n > 1 else 0
        if extent < 2 ** 31 and (n == 1 or extent <= img < 2 ** 31):
            return img, plane, pos
    raise ValueError(f"{name}: expected an NHWC view [N, H, W, C] with evenly spaced positions or a blocked "
                     f"view [N, H, W, C/8, 8], 8-aligned channels, got shape {tuple(t.shape)} strides {s}")


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def epilogue(v: torch.Tensor, slope: Optional[float], res: Optional[torch.Tensor], res_scale: float,
             res2: Optional[torch.Tensor], res2_scale: float) -> torch.Tensor:
    """The kernel's epilogue on fp32 `v` (the sums plus the bias), each
    operation rounded in fp32."""
    if slope is not None:
        v = torch.where(v < 0, v * slope, v)
    if res is not None:
        v = to_nhwc(res).float() + v * res_scale
    if res2 is not None:
        v = to_nhwc(res2).float() + v * res2_scale
    return v


def rrdb_conv_plain(src: torch.Tensor, conv: Conv, out: torch.Tensor,
                    slope: Optional[float] = None, res: Optional[torch.Tensor] = None,
                    res_scale: float = 1.0, res2: Optional[torch.Tensor] = None,
                    res2_scale: float = 1.0) -> torch.Tensor:
    """The kernel's function in PyTorch ops: the fp32 conv of the prefix,
    the bias and the epilogue in fp32, one rounding into `out`."""
    v = conv3x3_f32(to_nhwc(channel_slice(src, 0, conv.cin)), conv.weight.permute(2, 3, 1, 0)) + conv.bias
    out.copy_(epilogue(v, slope, res, res_scale, res2, res2_scale).reshape(out.shape))
    return out


def ulp_fp16(v: torch.Tensor) -> torch.Tensor:
    """One fp16 ulp at |v| (fp32 out; the subnormal step below 2⁻¹⁴)."""
    v = v.float().abs()
    _, e = torch.frexp(v)
    return torch.exp2(torch.where(v > 0, torch.clamp(e - 11, min=-24), -24).float())


def ulp_tolerance(src: torch.Tensor, conv: Conv, plain: torch.Tensor,
                  res_scale: float = 1.0, res2_scale: float = 1.0) -> torch.Tensor:
    """The bound "≤ 1 fp16 ulp" of kernel against plain, per element:
    max(ulp_fp16(|plain|), 2⁻²⁰ · Σ|x|·|w| scaled as the epilogue scales the
    sum), the second term for sums that cancel."""
    mag = conv3x3_f32(to_nhwc(channel_slice(src, 0, conv.cin)).abs(), conv.weight.abs().permute(2, 3, 1, 0))
    return torch.maximum(ulp_fp16(to_nhwc(plain)), CANCEL_REL * mag * abs(res_scale * res2_scale)).reshape(
        plain.shape)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _shape(name: str, t: torch.Tensor) -> tuple[int, int, int, int]:
    """(N, H, W, C) of an NHWC or blocked tensor; raises for other shapes."""
    if 0 in t.shape or not (t.dim() == 4 or (t.dim() == 5 and t.shape[4] == BLOCK)):
        raise ValueError(f"{name}: expected NHWC [N, H, W, C] or blocked [N, H, W, C/8, 8], "
                         f"got {tuple(t.shape)}")
    return (*t.shape[:3], channels(t))


def check_inputs(src: torch.Tensor, conv: Conv, out: torch.Tensor,
                 res: Optional[torch.Tensor], res2: Optional[torch.Tensor]) -> None:
    """Shapes and devices of a call: `src` with at least the conv's Cin
    channels, `out` and the residuals [N, H, W, Cout], each NHWC or blocked,
    all on src's device and of its dtype."""
    n, h, w, c = _shape("src", src)
    if conv.cin > c:
        raise ValueError(f"the conv reads {conv.cin} channels, src holds {c}")
    if res2 is not None and res is None:
        raise ValueError("res2 applies after res: give res too")
    want = (n, h, w, conv.cout)
    for name, t in (("out", out), ("res", res), ("res2", res2)):
        if t is None:
            continue
        if _shape(name, t) != want:
            raise ValueError(f"{name}: expected {list(want)}, got {tuple(t.shape)}")
        if t.device != src.device or t.dtype != src.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, src {src.dtype} on {src.device}")


def _launch(src: torch.Tensor, conv: Conv, out: torch.Tensor, slope: Optional[float],
            res: Optional[torch.Tensor], res_scale: float, res2: Optional[torch.Tensor],
            res2_scale: float) -> None:
    """One launch of the kernel; raises on what it does not take."""
    if src.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs a CUDA tensor, got {src.device}")
    if src.dtype != torch.float16 or conv.packed is None or conv.packed.dtype != torch.float16:
        raise TypeError(f"the rrdb_conv kernel takes fp16 operands packed on the card, got {src.dtype}")
    epi = (conv.cout, slope is not None, (res is not None) + (res2 is not None))
    if conv.cin % CHUNK or epi not in EPILOGUES:
        raise ValueError(f"the rrdb_conv kernel takes Cin in multiples of {CHUNK} and (Cout, "
                         f"LeakyReLU, residuals) in {EPILOGUES}, got {conv.cin} and {epi}")
    from nu_scaler_tpu_torch.kernels import _build

    lib = _build.load_library("rrdb_conv")
    n, h, w, c = _shape("src", src)

    def view(name: str, t: Optional[torch.Tensor]) -> tuple:
        return (None, 0, 0, 0) if t is None else (t.data_ptr(), *strides(name, t))

    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.nu_rrdb_conv(
        src.device.index or 0, *view("src", src), n, h, w, c, conv.cin, conv.packed.data_ptr(),
        conv.bias.data_ptr(), conv.cout, *view("out", out),
        int(slope is not None), 0.0 if slope is None else float(slope),
        *view("res", res), float(res_scale), *view("res2", res2), float(res2_scale), stream)
    if err != 0:
        raise RuntimeError(f"rrdb_conv launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})")


def rrdb_conv(src: torch.Tensor, conv: Conv, out: torch.Tensor,
              slope: Optional[float] = None, res: Optional[torch.Tensor] = None,
              res_scale: float = 1.0, res2: Optional[torch.Tensor] = None,
              res2_scale: float = 1.0) -> torch.Tensor:
    """The conv of src's first ``conv.cin`` channels into `out` with the
    epilogue (the module's docstring); returns `out`. One launch on a card."""
    check_inputs(src, conv, out, res, res2)
    if src.device.type == "cpu":
        return rrdb_conv_plain(src, conv, out, slope, res, res_scale, res2, res2_scale)
    layout = "blocked" if src.dim() == 5 else "nhwc"
    with span("nu.kernels.rrdb_conv", layout=layout):
        _launch(src, conv, out, slope, res, res_scale, res2, res2_scale)
    launches["rrdb_conv"] += 1
    launches["blocked"] += layout == "blocked"
    return out
