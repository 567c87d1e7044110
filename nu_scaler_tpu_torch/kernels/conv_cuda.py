"""Wrapper of the bf16 tensor-core 3×3 conv kernel (`csrc/conv3x3.cu`) and
its plain PyTorch version.

`conv3x3` replaces `nu_scaler_tpu/kernels/conv_pallas.py:50` make_conv3x3
(→ `_make_kernel` :26): a 3×3 SAME (zero padding) convolution of bf16 NHWC
``[N, H, W, Cin]`` with bf16 HWIO weights ``[3, 3, Cin, Cout]`` and a bf16
bias ``[Cout]`` to bf16 ``[N, H, W, Cout]``, Cin and Cout multiples of 128.
A conv of another width (the stride-2 and stride-8 archs, the RGB heads and
tails of the non-exact-ratio graph, ESRGANLite) runs on the same kernel with
its weights zero-padded once at load (`pad_weights`) and its activations'
lanes zero-padded (`conv3x3_padded`), which is exact.
What both versions compute, in the Pallas kernel's order of rounding: the 9
taps' products summed in fp32 (bf16 × bf16 is exact in fp32), the bias added
in fp32 after the sum, then ReLU if asked, then one rounding to bf16. With
``round_sum=True`` the sum is rounded to bf16 first and the bias is added to
it in bf16: the rounding of the JAX serving graph, whose XLA conv returns
bf16 before its separate bias add (`esrgan_lite.py:1025-1030`). The learned
tier serves that form; it moves the served bytes by up to 12 LSB against
the single rounding (on the trained tpu4b2 x2 weights, 40.4 dB against JAX's
served bytes with one rounding, 68.2 dB with two, on a 32×64 noise frame).

The kernel takes the weights repacked to ``[Cout, 3, 3, Cin]``
(`pack_weights`: one copy of 9·Cin·Cout bf16 per launch, inside `_launch`),
the K-major layout of its tensor-core B operand. The sums run in another
order in the kernel (warpgroup MMAs over 16-channel steps, tap by tap) than
in the plain version (9 fp32 matmuls), so the two
agree to one bf16 ulp, or, where the sum cancels, to a small multiple of the
fp32 rounding of the terms' magnitude: `ulp_tolerance` states the bound. A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.

`conv3x3_q` is the same kernel with its int8-grid epilogue: the counterpart
of the XLA conv `_conv_i8` (`nu_scaler_tpu/models/esrgan_lite.py:719`) that
the int8 learned ladders serve. Its input is already on the int8 grid
(`quantize_act`: integers in [-127, 127], exact in bf16), its weights are
the int8 kernel as integer-valued bf16, and per output channel it takes an
fp32 ``scale = f32(dq) · f32(ax/127)`` and an optional fp32 bias:
``bf16_rn(relu(sum · scale[o] + bias[o]))``, one fp32 multiply and one fp32
add, no FMA. The products are integers below 2^14 and every partial sum of
the committed weights stays below 0.311 · 2^24 for any input
(`int8_sum_bound`), so the kernel's fp32 sums are the int32 sums of
`_conv_i8` in any order: kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from nu_scaler_tpu_torch.utils.tracing import span

# Launches since the last `reset_launches()`; the wrapper adds one where it
# launches its kernel and nowhere else.
launches = {"conv3x3": 0, "conv3x3_q": 0}

LANES = 128  # Cin and Cout must be multiples of this (the Pallas kernel's rule)
# the cancellation term of the tolerance: 2^-20 of Σ|x|·|w| at the element
CANCEL_REL = 2.0 ** -20


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_fp32_matmul():
    """fp32 matmuls in full fp32 (no TF32 on the card) inside the block: each
    matmul backend's own switch (`torch.backends.cuda.matmul` and
    `torch.backends.mkldnn.matmul` ``.fp32_precision``) is set to "ieee" and
    restored after. The process-wide `torch.get_float32_matmul_precision`
    is not read: it raises once a process has mixed the legacy
    ``allow_tf32`` switches with the per-backend ones."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    old = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, value in zip(backends, old):
            b.fp32_precision = value


def conv_valid_f32(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """3×3 VALID conv of `xp` [N, H + 2, W + 2, Cin] (already padded) with
    `k` [3, 3, Cin, Cout]: Σ over the 9 taps of the shifted
    ``[P, Cin] · [Cin, Cout]`` products, in fp32 on their values → fp32
    [N, H, W, Cout]."""
    n, h, w, cin = xp.shape[0], xp.shape[1] - 2, xp.shape[2] - 2, xp.shape[3]
    xp, kf = xp.float(), k.float()
    acc = None
    with full_fp32_matmul():
        for dy in range(3):
            for dx in range(3):
                tap = xp[:, dy : dy + h, dx : dx + w, :].reshape(-1, cin) @ kf[dy, dx]
                acc = tap if acc is None else acc.add_(tap)
    return acc.reshape(n, h, w, -1)


def conv3x3_f32(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """3×3 SAME (zero padding) conv of `x` [N, H, W, Cin] in fp32 → fp32
    [N, H, W, Cout]."""
    return conv_valid_f32(F.pad(x.float(), (0, 0, 1, 1, 1, 1)), k)


def conv3x3_plain(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu: bool,
                  round_sum: bool = False) -> torch.Tensor:
    """The kernel's function in PyTorch ops: bf16 in, fp32 sums (rounded to
    bf16 with `round_sum`), bias then ReLU in fp32, one rounding to bf16."""
    acc = conv3x3_f32(x, k)
    if round_sum:
        acc = acc.to(torch.bfloat16).float()
    acc = acc + b.float()
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(torch.bfloat16)


def quantize_act(x: torch.Tensor, ax: float, dtype=torch.bfloat16) -> torch.Tensor:
    """`_conv_i8`'s activation quantiser (`esrgan_lite.py:730-734`):
    clamp(round(x · f32(127/ax)), -127, 127), 127/ax formed in double and
    cast, the product in fp32, ties to even; integer values, as `dtype`
    (bf16 holds them exactly)."""
    inv = torch.tensor(127.0 / ax, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(dtype)


def qgrid_scale(dq, ax: float) -> torch.Tensor:
    """The per-output-channel dequantisation `_conv_i8` applies:
    f32(dq) · f32(ax/127), in fp32 (an fp32 tensor on dq's device, or the
    CPU for a numpy dq)."""
    dq = torch.as_tensor(dq, dtype=torch.float32)
    return dq * torch.tensor(ax / 127.0, dtype=torch.float32, device=dq.device)


def int8_sum_bound(kq) -> float:
    """127 · max_o Σ|kq[..., o]|: no partial sum of a conv on the int8 grid
    (|x| ≤ 127) exceeds it, in any order of summation."""
    kq = torch.as_tensor(kq).double().abs()
    return float(127.0 * kq.sum(dim=(0, 1, 2)).max())


def conv3x3_q_plain(xq: torch.Tensor, kq: torch.Tensor, scale: torch.Tensor,
                    b: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """The int8-grid kernel's function in PyTorch ops: the fp32 conv of the
    integer values (exact below 2^24), · scale, + bias, each rounded in fp32,
    ReLU, one rounding to bf16."""
    acc = conv3x3_f32(xq, kq) * scale
    if b is not None:
        acc = acc + b
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(torch.bfloat16)


def lanes(c: int) -> int:
    """`c` channels rounded up to a multiple of `LANES`, the kernel's width."""
    return -(-c // LANES) * LANES


def pad_weights(k: np.ndarray, b: Optional[np.ndarray] = None):
    """A conv of any width on the kernel's widths, once at load: HWIO `k`
    [3, 3, Cin, Cout] → [3, 3, lanes(Cin), lanes(Cout)] with zero kernel rows
    for the padded inputs and zero columns for the padded outputs, and the
    bias [Cout] → [lanes(Cout)] with zeros (returned with k when given)."""
    cin, cout = k.shape[2], k.shape[3]
    kp = np.zeros((3, 3, lanes(cin), lanes(cout)), np.float32)
    kp[:, :, :cin, :cout] = k
    if b is None:
        return kp
    bp = np.zeros((lanes(cout),), np.float32)
    bp[:cout] = b
    return kp, bp


def pad_lanes(x: torch.Tensor, c: int) -> torch.Tensor:
    """x [..., C] → [..., c] with zero lanes appended (x itself when C is c)."""
    if x.shape[-1] == c:
        return x.contiguous()
    return torch.cat([x, x.new_zeros((*x.shape[:-1], c - x.shape[-1]))], dim=-1)


def conv3x3_padded(x: torch.Tensor, kp: torch.Tensor, bp: torch.Tensor, cout: int,
                   relu: bool = False, round_sum: bool = False, conv=None) -> torch.Tensor:
    """A 3×3 conv of any width through `conv` (`conv3x3` by default): `x`
    [N, H, W, C ≤ Cin'] zero-padded to the padded weights' Cin' (`pad_lanes`),
    `kp` and `bp` from `pad_weights`, and the output's padded lanes sliced
    off past `cout`. Exact: a padded lane adds +0 products to each fp32 sum,
    and a padded output is 0 + 0 (ReLU(0) = 0)."""
    y = (conv or conv3x3)(pad_lanes(x, kp.shape[2]), kp, bp, relu, round_sum)
    return y if y.shape[-1] == cout else y[..., :cout]


def conv3x3_padded_plain(x: torch.Tensor, kp: torch.Tensor, bp: torch.Tensor, cout: int,
                         relu: bool = False, round_sum: bool = False) -> torch.Tensor:
    """`conv3x3_padded` on the kernel's plain version."""
    return conv3x3_padded(x, kp, bp, cout, relu, round_sum, conv3x3_plain)


def ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (fp32 out; 0 where v is 0)."""
    v = v.float().abs()
    _, e = torch.frexp(v)
    return torch.where(v > 0, torch.exp2((e - 8).float()), torch.zeros_like(v))


def ulp_tolerance(x: torch.Tensor, k: torch.Tensor, plain: torch.Tensor,
                  round_sum: bool = False) -> torch.Tensor:
    """The bound "≤ 1 bf16 ulp" of kernel against plain, per element:
    max(ulp_bf16(|plain|), 2⁻²⁰ · Σ|x|·|w|), the second term for sums that
    cancel, where fp32 sums in another order differ by more than one ulp of
    a small result. With `round_sum`, one bf16 ulp of the sum is added: the
    two sums may round to neighbouring bf16 values before the bias."""
    tol = torch.maximum(ulp_bf16(plain), CANCEL_REL * conv3x3_f32(x.abs(), k.abs()))
    return tol + ulp_bf16(conv3x3_f32(x, k)) if round_sum else tol


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def check_inputs(x: torch.Tensor, k: torch.Tensor, b: Optional[torch.Tensor],
                 scale: Optional[torch.Tensor] = None) -> None:
    """The operands of either mode: bf16 x and k; without `scale` a bf16
    bias b, with it (the int8-grid mode) an fp32 scale and an fp32 bias or
    None; all contiguous on x's device; Cin and Cout multiples of `LANES`."""
    vector = torch.bfloat16 if scale is None else torch.float32
    named = [("x", x, torch.bfloat16), ("k", k, torch.bfloat16), ("b", b, vector)]
    if scale is not None:
        named.append(("scale", scale, torch.float32))
        if b is None:
            named.pop(2)
    for name, t, dtype in named:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name}: expected a {str(dtype).removeprefix('torch.')} torch.Tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"x: expected NHWC [N, H, W, Cin], got {tuple(x.shape)}")
    cin = x.shape[-1]
    if k.dim() != 4 or k.shape[:3] != (3, 3, cin):
        raise ValueError(f"k: expected HWIO [3, 3, {cin}, Cout], got {tuple(k.shape)}")
    cout = k.shape[-1]
    for name, t, _ in named[2:]:
        if tuple(t.shape) != (cout,):
            raise ValueError(f"{name}: expected [{cout}], got {tuple(t.shape)}")
    if cin % LANES or cout % LANES:
        raise ValueError(f"the conv kernel takes Cin and Cout in multiples of {LANES}, "
                         f"got {cin} and {cout}")


def pack_weights(k: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, Cin, Cout]`` → ``[Cout, 3, 3, Cin]``, contiguous:
    ``packed[o, dy, dx, c] == k[dy, dx, c, o]``. Each output channel's 9·Cin
    weights are one row, K-major, as the kernel's B operand takes them."""
    return k.permute(3, 0, 1, 2).contiguous()


def _launch(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu: bool,
            round_sum: bool) -> torch.Tensor:
    """One launch of the kernel on the weights repacked by `pack_weights`."""
    if x.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")
    from nu_scaler_tpu_torch.kernels import _build

    lib = _build.load_library("conv3x3")
    n, h, w, cin = x.shape
    cout = k.shape[-1]
    kp = pack_weights(k)
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.nu_conv3x3(x.device.index or 0, x.data_ptr(), kp.data_ptr(), b.data_ptr(),
                         out.data_ptr(), n, h, w, cin, cout, int(relu), int(round_sum), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})")
    return out


def _launch_q(xq: torch.Tensor, kq: torch.Tensor, scale: torch.Tensor,
              b: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """One launch of the kernel's int8-grid mode, weights
    repacked by `pack_weights`; a None bias passes a null pointer."""
    if xq.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs a CUDA tensor, got {xq.device}")
    from nu_scaler_tpu_torch.kernels import _build

    lib = _build.load_library("conv3x3")
    n, h, w, cin = xq.shape
    cout = kq.shape[-1]
    kp = pack_weights(kq)
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.nu_conv3x3_q(xq.device.index or 0, xq.data_ptr(), kp.data_ptr(), scale.data_ptr(),
                           None if b is None else b.data_ptr(), out.data_ptr(),
                           n, h, w, cin, cout, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_q launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})")
    return out


def conv3x3_q(xq: torch.Tensor, kq: torch.Tensor, scale: torch.Tensor,
              b: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """The int8-grid conv: integer-valued bf16 [N, H, W, Cin] (`quantize_act`)
    and integer-valued bf16 HWIO weights → bf16 [N, H, W, Cout] =
    bf16_rn(relu(sum · scale[o] + b[o])), 3×3 SAME, one launch."""
    check_inputs(xq, kq, b, scale)
    if xq.device.type == "cpu":
        return conv3x3_q_plain(xq, kq, scale, b, relu)
    with span("nu.kernels.conv3x3_q"):
        out = _launch_q(xq, kq, scale, b, relu)
    launches["conv3x3_q"] += 1
    return out


def conv3x3(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu: bool = False,
            round_sum: bool = False) -> torch.Tensor:
    """bf16 [N, H, W, Cin] → bf16 [N, H, W, Cout]: 3×3 SAME conv + bias
    (+ ReLU), one launch (batch = grid z)."""
    check_inputs(x, k, b)
    if x.device.type == "cpu":
        return conv3x3_plain(x, k, b, relu, round_sum)
    out = _launch(x, k, b, relu, round_sum)
    launches["conv3x3"] += 1
    return out
