"""Wrapper of RRDBNet's dense-block conv kernel (`csrc/rrdb_conv.cu`) and its
plain PyTorch version.

`rrdb_conv` is a 3×3 SAME (zero padding) conv in fp16 with fp32 sums that
reads its input as the channel prefix ``src[..., :Cin]`` of an NHWC tensor in
place, and writes its Cout (32 or 64) channels into `out`, a channel slice of
another NHWC tensor, after an epilogue in fp32 with one rounding at the end:

    v = conv(src[..., :Cin]) + bias
    v = lrelu(v, slope)            if slope is given
    v = res + res_scale · v        if res is given
    v = res2 + res2_scale · v      if res2 is given
    out = v (rounded to out's dtype)

each multiply and add rounded in fp32. `models/rrdbnet.py` `RRDBServing`
runs every conv of its 23 RRDBs, `conv_body` and the upsampling convs on it,
over one growth buffer per RDB (PERF.md §5). It replaces no TPU kernel: the
JAX package has no RRDBNet; it replaces cuDNN there.

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

from nu_scaler_tpu_torch.kernels.conv_cuda import conv3x3_f32
from nu_scaler_tpu_torch.utils.tracing import span

# Launches since the last `reset_launches()`; the wrapper adds one where it
# launches its kernel and nowhere else.
launches = {"rrdb_conv": 0}

CHUNK = 16  # Cin must be a multiple of this (the kernel's channel chunk)
# The kernel's epilogues, (Cout, LeakyReLU, residuals), as RRDBNet uses them:
# conv1-4 and the upsampling convs, conv5 and conv_body, an RRDB's last conv5.
EPILOGUES = ((32, True, 0), (64, True, 0), (64, False, 1), (64, False, 2))
CANCEL_REL = 2.0 ** -20  # the cancellation term of the tolerance (see conv_cuda)


def reset_launches() -> None:
    launches["rrdb_conv"] = 0


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
# plain PyTorch version
# ---------------------------------------------------------------------------


def epilogue(v: torch.Tensor, slope: Optional[float], res: Optional[torch.Tensor], res_scale: float,
             res2: Optional[torch.Tensor], res2_scale: float) -> torch.Tensor:
    """The kernel's epilogue on fp32 `v` (the sums plus the bias), each
    operation rounded in fp32."""
    if slope is not None:
        v = torch.where(v < 0, v * slope, v)
    if res is not None:
        v = res.float() + v * res_scale
    if res2 is not None:
        v = res2.float() + v * res2_scale
    return v


def rrdb_conv_plain(src: torch.Tensor, conv: Conv, out: torch.Tensor,
                    slope: Optional[float] = None, res: Optional[torch.Tensor] = None,
                    res_scale: float = 1.0, res2: Optional[torch.Tensor] = None,
                    res2_scale: float = 1.0) -> torch.Tensor:
    """The kernel's function in PyTorch ops: the fp32 conv of the prefix,
    the bias and the epilogue in fp32, one rounding into `out`."""
    v = conv3x3_f32(src[..., :conv.cin], conv.weight.permute(2, 3, 1, 0)) + conv.bias
    out.copy_(epilogue(v, slope, res, res_scale, res2, res2_scale))
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
    mag = conv3x3_f32(src[..., :conv.cin].abs(), conv.weight.abs().permute(2, 3, 1, 0))
    return torch.maximum(ulp_fp16(plain), CANCEL_REL * mag * abs(res_scale * res2_scale))


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _position_stride(name: str, t: torch.Tensor) -> int:
    """The stride between positions of an NHWC view whose channels are
    contiguous and whose positions are evenly spaced (a channel slice of a
    contiguous NHWC tensor); raises for any other layout."""
    n, h, w, c = t.shape
    s = t.stride()
    if s[3] != 1 or s[2] < c or s[1] != w * s[2] or (n > 1 and s[0] != h * s[1]):
        raise ValueError(f"{name}: expected an NHWC view with evenly spaced positions, "
                         f"got shape {tuple(t.shape)} strides {s}")
    return s[2]


def check_inputs(src: torch.Tensor, conv: Conv, out: torch.Tensor,
                 res: Optional[torch.Tensor], res2: Optional[torch.Tensor]) -> None:
    """Shapes and devices of a call: NHWC `src` with at least the conv's Cin
    channels, `out` and the residuals [N, H, W, Cout], all on src's device
    and of its dtype."""
    if src.dim() != 4 or 0 in src.shape:
        raise ValueError(f"src: expected NHWC [N, H, W, C], got {tuple(src.shape)}")
    if conv.cin > src.shape[-1]:
        raise ValueError(f"the conv reads {conv.cin} channels, src holds {src.shape[-1]}")
    if res2 is not None and res is None:
        raise ValueError("res2 applies after res: give res too")
    want = (*src.shape[:3], conv.cout)
    for name, t in (("out", out), ("res", res), ("res2", res2)):
        if t is None:
            continue
        if tuple(t.shape) != want:
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
    n, h, w, _ = src.shape
    c_total = _position_stride("src", src)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.nu_rrdb_conv(
        src.device.index or 0, src.data_ptr(), n, h, w, c_total, conv.cin, conv.packed.data_ptr(),
        conv.bias.data_ptr(), conv.cout, out.data_ptr(), _position_stride("out", out),
        int(slope is not None), 0.0 if slope is None else float(slope),
        None if res is None else res.data_ptr(), 0 if res is None else _position_stride("res", res),
        float(res_scale), None if res2 is None else res2.data_ptr(),
        0 if res2 is None else _position_stride("res2", res2), float(res2_scale), stream)
    if err != 0:
        raise RuntimeError(f"rrdb_conv launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})")


def rrdb_conv(src: torch.Tensor, conv: Conv, out: torch.Tensor,
              slope: Optional[float] = None, res: Optional[torch.Tensor] = None,
              res_scale: float = 1.0, res2: Optional[torch.Tensor] = None,
              res2_scale: float = 1.0) -> torch.Tensor:
    """The conv of ``src[..., :conv.cin]`` into `out` with the epilogue (the
    module's docstring); returns `out`. One launch on a card."""
    check_inputs(src, conv, out, res, res2)
    if src.device.type == "cpu":
        return rrdb_conv_plain(src, conv, out, slope, res, res_scale, res2, res2_scale)
    with span("nu.kernels.rrdb_conv"):
        _launch(src, conv, out, slope, res, res_scale, res2, res2_scale)
    launches["rrdb_conv"] += 1
    return out
