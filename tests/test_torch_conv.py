"""The port's 3×3 conv (`nu_scaler_tpu_torch/kernels/conv_cuda.py`) against
the JAX package's Pallas `make_conv3x3` (interpret mode on the CPU) and the
serving graph's XLA conv, on the CPU: the wrapper runs its plain version.

Bound, everywhere: "≤ 1 bf16 ulp" as `conv_cuda.ulp_tolerance` states it,
|port − reference| ≤ max(ulp_bf16(|reference|), 2⁻²⁰·Σ|x|·|w|) per element
(the second term for sums that cancel); with ``round_sum`` one more ulp of
the sum, which may round to the neighbouring bf16 value before the bias."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.kernels.conv_pallas import make_conv3x3
from nu_scaler_tpu_torch.kernels import conv_cuda as cc


def _inputs(rng, n, h, w, cin, cout):
    """bf16 numpy-seeded x in [0, 1), k and b in [−0.5, 0.5) (the Pallas
    tests' ranges), as torch tensors."""
    x = rng.random((n, h, w, cin), np.float32)
    k = rng.random((3, 3, cin, cout), np.float32) - 0.5
    b = rng.random((cout,), np.float32) - 0.5
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (x, k, b))


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _within(got: torch.Tensor, want: torch.Tensor, tol: torch.Tensor) -> float:
    """Share of elements outside the bound (0 passes); asserts shapes."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs()
    return float((d > tol).float().mean())


@pytest.mark.parametrize("h, w, cout, relu", [
    (32, 48, 128, True), (32, 48, 128, False),
    (27, 40, 128, True), (27, 40, 128, False),  # 27 rows: not a multiple of the strip
    (16, 24, 256, False),
])
def test_plain_matches_pallas_conv3x3(rng, h, w, cout, relu):
    x, k, b = _inputs(rng, 1, h, w, 128, cout)
    fn = make_conv3x3(h, w, 128, cout, relu=relu)
    want = torch.from_numpy(np.asarray(fn(_jnp(x[0]), _jnp(k), _jnp(b)), np.float32))[None]
    got = cc.conv3x3(x, k, b, relu)
    assert _within(got, want.to(torch.bfloat16), cc.ulp_tolerance(x, k, want)) == 0.0
    # the rounding is the Pallas kernel's: most values equal bit for bit
    assert float((got.float() == want).float().mean()) > 0.97


@pytest.mark.parametrize("relu", [True, False])
def test_round_sum_matches_xla_conv_plus_bias(rng, relu):
    """round_sum=True is the serving graph's `conv(x, k, b)`: an XLA conv in
    bf16 (the fp32 sum rounded once), then the bias added in bf16."""
    x, k, b = _inputs(rng, 2, 12, 20, 128, 256)
    y = jax.lax.conv_general_dilated(
        _jnp(x), _jnp(k), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")) + _jnp(b)
    if relu:
        y = jax.nn.relu(y)
    want = torch.from_numpy(np.asarray(y, np.float32)).to(torch.bfloat16)
    got = cc.conv3x3(x, k, b, relu, round_sum=True)
    assert _within(got, want, cc.ulp_tolerance(x, k, want.float(), round_sum=True)) == 0.0
    assert float((got == want).float().mean()) > 0.97
    # and it is not the single rounding: the bias added after the sum's
    # rounding moves some values
    assert not torch.equal(got, cc.conv3x3(x, k, b, relu))


def test_batch_is_per_image(rng):
    x, k, b = _inputs(rng, 3, 9, 17, 128, 128)
    out = cc.conv3x3(x, k, b, True)
    for i in range(3):
        assert torch.equal(out[i:i + 1], cc.conv3x3(x[i:i + 1].contiguous(), k, b, True))


def test_zero_padding_at_the_border(rng):
    """SAME: a one-hot input at the corner gives the kernel's taps that
    fall inside the frame, nothing else."""
    x = torch.zeros((1, 5, 6, 128), dtype=torch.bfloat16)
    x[0, 0, 0, 3] = 1.0
    _, k, _ = _inputs(rng, 1, 1, 1, 128, 128)
    b = torch.zeros(128, dtype=torch.bfloat16)
    out = cc.conv3x3(x, k, b).float()
    for y in range(5):
        for xx in range(6):
            want = k[1 - y, 1 - xx, 3].float() if y <= 1 and xx <= 1 else torch.zeros(128)
            assert torch.equal(out[0, y, xx], want)


def test_ulp_bf16():
    v = torch.tensor([1.0, 1.5, 1.9921875, 2.0, 3.0, -0.75, 0.0, 255.0])
    want = torch.tensor([2**-7, 2**-7, 2**-7, 2**-6, 2**-6, 2**-8, 0.0, 1.0])
    assert torch.equal(cc.ulp_bf16(v), want)


def test_wrapper_checks(rng):
    x, k, b = _inputs(rng, 1, 4, 4, 128, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        cc.conv3x3(x.float(), k, b)
    with pytest.raises(ValueError, match="contiguous"):
        cc.conv3x3(x.permute(0, 2, 1, 3), k, b)
    with pytest.raises(ValueError, match="NHWC"):
        cc.conv3x3(x[0], k, b)
    with pytest.raises(ValueError, match="HWIO"):
        cc.conv3x3(x, k[:, :, :64].contiguous(), b)
    with pytest.raises(ValueError, match=r"b: expected \[128\]"):
        cc.conv3x3(x, k, b[:64].contiguous())
    x64, k64, b64 = _inputs(rng, 1, 4, 4, 64, 128)
    with pytest.raises(ValueError, match="multiples of 128"):
        cc.conv3x3(x64, k64, b64)
    with pytest.raises(ValueError, match="multiples of 128"):
        cc.conv3x3(x, k[..., :64].contiguous(), b[:64].contiguous())
    with pytest.raises(ValueError, match="is on meta"):
        cc.conv3x3(x, k.to("meta"), b)


def test_cpu_runs_plain_and_counts_no_launch(rng):
    x, k, b = _inputs(rng, 1, 6, 7, 128, 128)
    cc.reset_launches()
    assert torch.equal(cc.conv3x3(x, k, b, True), cc.conv3x3_plain(x, k, b, True))
    assert cc.launches == {"conv3x3": 0, "conv3x3_q": 0}
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        cc._launch(x, k, b, True, False)


@pytest.mark.parametrize("cin, cout", [(128, 128), (256, 128), (128, 1024)])
def test_pack_weights_index_map(rng, cin, cout):
    """packed[o, dy, dx, c] == k[dy, dx, c, o], contiguous: the kernel's
    K-major B operand."""
    _, k, _ = _inputs(rng, 1, 1, 1, cin, cout)
    packed = cc.pack_weights(k)
    assert packed.shape == (cout, 3, 3, cin) and packed.is_contiguous()
    o, dy, dx, c = (rng.integers(0, n, 64) for n in (cout, 3, 3, cin))
    assert torch.equal(packed[o, dy, dx, c], k[dy, dx, c, o])
    assert torch.equal(packed.permute(1, 2, 3, 0), k)


def test_launch_on_cpu_raises(rng):
    x, k, b = _inputs(rng, 1, 4, 4, 128, 128)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        cc._launch(x, k, b, False, True)


@pytest.mark.parametrize("cin, cout", [(192, 128), (128, 192), (64, 256)])
def test_wrapper_rejects_channels_off_the_lanes(rng, cin, cout):
    x, k, b = _inputs(rng, 1, 4, 4, cin, cout)
    with pytest.raises(ValueError, match="multiples of 128"):
        cc.conv3x3(x, k, b)


def test_two_cin_chunks_match_pallas(rng):
    """Cin = 256 (the kernel's two halo chunks) on a frame no 16×16 tile
    divides: the wrapper's plain version against the Pallas kernel."""
    x, k, b = _inputs(rng, 1, 17, 33, 256, 128)
    fn = make_conv3x3(17, 33, 256, 128, relu=True)
    want = torch.from_numpy(np.asarray(fn(_jnp(x[0]), _jnp(k), _jnp(b)), np.float32))[None]
    got = cc.conv3x3(x, k, b, True)
    assert _within(got, want.to(torch.bfloat16), cc.ulp_tolerance(x, k, want)) == 0.0


_TF32_SWITCHES = (
    (torch.backends.cuda.matmul, "fp32_precision"),
    (torch.backends.mkldnn.matmul, "fp32_precision"),
    (torch.backends.cudnn.conv, "fp32_precision"),
    (torch.backends.cudnn.rnn, "fp32_precision"),
    (torch.backends.mkldnn.conv, "fp32_precision"),
    (torch.backends.mkldnn.rnn, "fp32_precision"),
)


@pytest.fixture
def tf32_switches():
    """Every per-backend fp32 precision switch, restored after the test."""
    saved = [getattr(obj, name) for obj, name in _TF32_SWITCHES]
    yield
    for (obj, name), value in zip(_TF32_SWITCHES, saved):
        setattr(obj, name, value)


def test_full_fp32_matmul_after_mixed_tf32_apis(rng, tf32_switches):
    """A caller that set TF32 through the process-wide API and then through
    the legacy switch leaves `torch.get_float32_matmul_precision()` raising;
    the fp32 conv (every conv of the port, serving and training) must still
    run, in full fp32, and leave the caller's settings as they were."""
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = False
    with pytest.raises(RuntimeError):
        torch.get_float32_matmul_precision()
    before = (torch.backends.cuda.matmul.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision)
    x = torch.from_numpy(rng.random((1, 9, 11, 16), np.float32))
    k = torch.from_numpy(rng.random((3, 3, 16, 8), np.float32) - 0.5)
    got = cc.conv3x3_f32(x, k)
    want = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), k.double().permute(3, 2, 0, 1), padding=1
    ).permute(0, 2, 3, 1)
    assert float((got.double() - want).abs().max()) < 1e-5
    assert (torch.backends.cuda.matmul.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision) == before
    with pytest.raises(RuntimeError):
        torch.get_float32_matmul_precision()


def test_fp32_training_restores_the_cudnn_switch(tf32_switches):
    """`esrgan_lite.fp32_training` sets cuDNN's conv switch to "ieee" inside
    the block and restores it, without reading the legacy getters."""
    from nu_scaler_tpu_torch.models import esrgan_lite as el

    torch.backends.cudnn.conv.fp32_precision = "tf32"
    torch.backends.cudnn.rnn.fp32_precision = "ieee"  # the legacy cuDNN getter now raises
    with el.fp32_training():
        assert torch.backends.cudnn.conv.fp32_precision == "ieee"
        assert torch.backends.cuda.matmul.fp32_precision == "ieee"
    assert torch.backends.cudnn.conv.fp32_precision == "tf32"
