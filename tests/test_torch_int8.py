"""The port's int8 learned ladders ("quality", the default, and "performance";
`nu_scaler_tpu_torch/models/esrgan_lite.py`, `kernels/conv_cuda.py`
`conv3x3_q`) against the JAX package's, on the CPU (the conv wrapper runs its
plain version): the exactness bound the kernel relies on, the int8 conv
against `_conv_i8`, the helpers and the fp32 twin against JAX's, the served
bytes against `make_serving_fn_fused(quant_scales=...)`, the bench's twin
gates and the ladder's picks.

Bounds. Against JAX run op by op (`jax.disable_jit()`), the port is bit-equal:
the same operations, each rounded where JAX rounds it. Against the jitted JAX
graph on the CPU the bound is the bf16 graph's (≥ 45 dB RGB, mean |d| < 1
LSB, alpha equal for α ≡ 255): XLA's CPU compiler keeps the fp32 value of
`_conv_i8`'s bf16 cast inside its fusions (excess precision; with
``--xla_allow_excess_precision=false`` the jitted bytes equal the port's), and
the int8 grid turns a kept half-ulp into a flipped quantisation step now and
then."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.models import esrgan_lite as el
from nu_scaler_tpu.models import train as etrain
from nu_scaler_tpu_torch.kernels import conv_cuda as cc
from nu_scaler_tpu_torch.models import esrgan_lite as pel
from test_torch_esrgan import bench_frame, psnr_rgb, to_u8

# (arch, upscale) → (stages, step, the ladder that serves it on the int8 grid)
INT8 = {("tpu4b2", 2): (1, 76000, "quality"), ("tpu4b1", 2): (1, 40000, "performance"),
        ("tpu4", 4): (2, 52000, "quality")}
ARCH_KW = {a: kw for ladder in ("quality", "performance") for a, kw, _ in el._ARCH_LADDER[ladder]}


@pytest.fixture(scope="module")
def restored():
    """orbax restores of the three int8 checkpoints and their scales."""
    out = {}
    for (arch, up), (stages, _, _) in INT8.items():
        params, step = etrain.load_checkpoint(stages, arch)
        out[(arch, up)] = (params, step, etrain.load_act_scales(stages, arch, step))
    return out


def _served_convs(arch: str, upscale: int):
    """Every int8 conv the served graph runs, by name: its int8 kernel."""
    model, _ = pel.load_model(arch, upscale)
    fs = pel.FusedServing(model, 8, 16, "cpu", quant_scales=pel.load_act_scales(arch, upscale))
    convs = {"trunk": fs.q_trunk, "tail": fs.q_tail}
    for i, (c1, c2) in enumerate(fs.q_blocks):
        convs[f"block{i}/conv1"], convs[f"block{i}/conv2"] = c1, c2
    if fs.q_head is not None:
        convs["head"] = fs.q_head
    if fs.q_base is not None:
        convs["base"] = fs.q_base
    return convs


@pytest.mark.parametrize("arch, upscale", list(INT8))
def test_int8_sums_stay_exact_in_fp32(arch, upscale):
    """127 · max_o Σ|kq[..., o]| < 2^24 for every int8 conv of the committed
    weights: no partial sum of any input on the int8 grid leaves fp32's
    integers, so the kernel's fp32 sums are `_conv_i8`'s int32 sums in any
    order. Measured: at most 0.311 of 2^24 (tpu4b2 block0/conv1)."""
    convs = _served_convs(arch, upscale)
    blocks = pel.load_model(arch, upscale)[0].blocks
    want = {"trunk", "tail", *(f"block{i}/conv{j}" for i in range(blocks) for j in (1, 2))}
    assert set(convs) == (want if arch == "tpu4" else want | {"head", "base"})
    for name, c in convs.items():
        kq = c.kq.float()
        assert torch.equal(kq, kq.round()) and float(kq.abs().max()) <= 127, name
        assert cc.int8_sum_bound(kq) < 0.32 * 2.0 ** 24, name


@pytest.mark.parametrize("cout", [128, 256])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_q_matches_conv_i8(rng, cout, relu, bias):
    """The int8-grid conv (quantise + `conv3x3_q`) against `_conv_i8`
    (+ ReLU after it, as the graph applies it): bit-equal to JAX op by op;
    against the jitted `_conv_i8` within 1 bf16 ulp (XLA's CPU compiler may
    contract the multiply and the bias add into one FMA)."""
    x = (rng.standard_normal((2, 9, 20, 128)) * 2).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    k = (rng.standard_normal((3, 3, 128, cout)) * 0.05).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    kq, dq = el._quant_kernel_i8(k)
    ax = 3.7

    def jconv(v):
        y = el._conv_i8(v, jnp.asarray(kq), jnp.asarray(dq), None if b is None else jnp.asarray(b), ax)
        return jax.nn.relu(y) if relu else y

    with jax.disable_jit():
        eager = np.asarray(jconv(xb).astype(jnp.float32))
    jitted = np.asarray(jax.jit(jconv)(xb).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = cc.conv3x3_q(cc.quantize_act(xt, ax), torch.from_numpy(kq.astype(np.float32)).to(torch.bfloat16),
                       cc.qgrid_scale(dq, ax), None if b is None else torch.from_numpy(b), relu)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 20, cout)
    got = got.float().numpy()
    assert np.array_equal(got, eager)
    tol = cc.ulp_bf16(torch.from_numpy(jitted)).numpy()
    assert np.all(np.abs(got - jitted) <= tol)


def test_quantize_act_matches_jax(rng):
    """`quantize_act` is `_conv_i8`'s quantiser: the same integers, ties to
    even, clipped at ±127, for bf16 and fp32 input."""
    x = np.concatenate([rng.standard_normal(4000).astype(np.float32) * 3,
                        np.arange(-10, 10, 0.5, dtype=np.float32) * (2.0 / 127)])
    for ax in (2.0, 0.6151762008666992, 255.0):
        for dt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
            xj = jnp.asarray(x, dt)
            want = np.asarray(jnp.clip(jnp.round(xj.astype(jnp.float32) * jnp.float32(127.0 / ax)), -127, 127))
            got = cc.quantize_act(torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt), ax)
            assert got.dtype == torch.bfloat16 and np.array_equal(got.float().numpy(), want)


def test_helpers_and_ladders_equal_jax(restored):
    rng = np.random.default_rng(11)
    for k in (rng.standard_normal((3, 3, 128, 256)).astype(np.float32),
              np.zeros((3, 3, 128, 4), np.float32),
              el._bilinear_base_kernel(4, 2, 4).astype(np.float32)):
        for port_fn, jax_fn in ((pel._quant_kernel_i8, el._quant_kernel_i8),
                                (pel._quant_kernel_i8_dc, el._quant_kernel_i8_dc)):
            for got, want in zip(port_fn(k), jax_fn(k)):
                assert got.dtype == want.dtype and np.array_equal(got, want)
    assert pel.ARCH_LADDER == el._ARCH_LADDER
    for (arch, up), (_, step, scales) in restored.items():
        assert pel.load_act_scales(arch, up) == scales and scales
        assert INT8[(arch, up)][1] == step
    assert pel.load_act_scales("tpu8w", 2) is None  # carried without a calibration, as in checkpoints/
    scale = cc.qgrid_scale(np.float32([0.5, 3e-3]), 0.7)
    want = np.float32([0.5, 3e-3]) * np.float32(0.7 / 127.0)
    assert scale.dtype == torch.float32 and np.array_equal(scale.numpy(), want)


@pytest.mark.parametrize("arch, upscale", list(INT8))
def test_quant_apply_matches_jax_twin(restored, arch, upscale):
    """`make_quant_apply`, the fp32 int8-grid twin: equal to JAX's run op by
    op within one fp32 rounding (measured: 0 and 1.2e-7), on seeded [0, 1]
    RGB. The jitted JAX twin contracts multiply-adds into FMAs, which now and
    then moves an activation across a quantisation tie: within a third of a
    u8 step of it (measured 6.9e-4 at tpu4b2, 1.2e-7 elsewhere)."""
    params, _, scales = restored[(arch, upscale)]
    model = el.ESRGANLiteTPU(upscale=upscale, **ARCH_KW[arch])
    jtw = el.make_quant_apply(model, params, scales)
    ptw = pel.make_quant_apply(pel.load_model(arch, upscale)[0], pel.load_act_scales(arch, upscale))
    x01 = np.random.default_rng(upscale).random((2, 16, 32, 3), np.float32)
    got = ptw(torch.from_numpy(x01)).numpy()
    with jax.disable_jit():
        eager = np.asarray(jtw(jnp.asarray(x01)))
    assert got.shape == eager.shape == (2, 16 * upscale, 32 * upscale, 3)
    assert np.max(np.abs(got - eager)) <= 2.4e-7
    assert np.max(np.abs(got - np.asarray(jtw(jnp.asarray(x01))))) <= 1 / 765


@pytest.fixture(scope="module")
def served(restored):
    """(JAX int8 serving fn, port upscaler) per (arch, upscale, h, w)."""
    cache = {}

    def get(arch, upscale, h, w):
        if (arch, upscale, h, w) not in cache:
            params, _, scales = restored[(arch, upscale)]
            model = el.ESRGANLiteTPU(upscale=upscale, **ARCH_KW[arch])
            jfn = el.make_serving_fn_fused(model, params, h, w, quant_scales=scales)
            prefer = INT8[(arch, upscale)][2]
            port = pel.make_pretrained_upscaler(h, w, upscale * h, upscale * w, prefer=prefer, device="cpu")
            assert (port.arch, port.quantized) == (arch, True)
            cache[(arch, upscale, h, w)] = (jfn, port)
        return cache[(arch, upscale, h, w)]

    return get


@pytest.mark.parametrize("arch, upscale", list(INT8))
@pytest.mark.parametrize("alpha", ["opaque", "random"])
def test_int8_served_matches_jax_serving(served, arch, upscale, alpha):
    """The port's int8 served bytes against JAX `make_serving_fn_fused(
    quant_scales=...)` on the committed weights and scales, a seeded 32×64
    noise frame: bit-equal to the graph run op by op; against the jitted
    graph ≥ 45 dB RGB, mean |d| < 1 LSB, alpha equal for α ≡ 255 (within 1
    LSB for random α). Measured against the jitted graph (α ≡ 255): tpu4b2
    x2 47.94 dB, mean 0.673, max 5; tpu4b1 x2 54.86 dB, mean 0.210, max 2;
    tpu4 x4 45.78 dB, mean 0.922, max 8 (see the module's docstring)."""
    jfn, port = served(arch, upscale, 32, 64)
    rng = np.random.default_rng(upscale * 1000 + 32)
    img = rng.integers(0, 256, (32, 64, 4), np.uint8)
    if alpha == "opaque":
        img[..., 3] = 255
    got = port(img).numpy()
    with jax.disable_jit():
        eager = np.asarray(jfn(jnp.asarray(img)))
    assert got.shape == eager.shape == (upscale * 32, upscale * 64, 4) and got.dtype == np.uint8
    assert np.array_equal(got, eager)
    want = np.asarray(jfn(jnp.asarray(img)))
    d = np.abs(got.astype(int) - want.astype(int))
    assert psnr_rgb(got, want) >= 45.0
    assert d[..., :3].mean() < 1.0
    assert d[..., 3].max() <= (0 if alpha == "opaque" else 1)
    if alpha == "opaque":
        assert np.all(got[..., 3] == 255)


@pytest.mark.parametrize("arch, upscale, h, w, gate", [
    ("tpu4b2", 2, 64, 128, 42.0), ("tpu4b1", 2, 64, 128, 42.0), ("tpu4", 4, 32, 64, 40.0)])
def test_int8_served_vs_bench_twin(restored, served, arch, upscale, h, w, gate):
    """The bench's int8 fidelity gate (`bench.py` `_gate_esrgan_twin` on the
    `make_quant_apply` twin, `_twin_model_fn`): served bytes against the
    twin rounded to u8, on the bench frame: ≥ 42 dB at x2, ≥ 40 dB at x4,
    against the port's twin and JAX's alike. Measured: tpu4b2 42.94 dB,
    tpu4b1 50.98, tpu4 41.44; JAX's served bytes read 43.00 / 50.97 / 41.57
    against the same twin."""
    params, _, scales = restored[(arch, upscale)]
    model = el.ESRGANLiteTPU(upscale=upscale, **ARCH_KW[arch])
    jtw = el.make_quant_apply(model, params, scales)
    ptw = pel.make_quant_apply(pel.load_model(arch, upscale)[0], pel.load_act_scales(arch, upscale))
    _, port = served(arch, upscale, h, w)
    img = bench_frame(h, w)
    x01 = img[None, ..., :3].astype(np.float32) / 255.0
    got = port(img).numpy()
    own = ptw(torch.from_numpy(x01))[0].numpy()
    assert psnr_rgb(got, to_u8(own)) >= gate
    assert psnr_rgb(got, to_u8(np.asarray(jtw(jnp.asarray(x01)))[0])) >= gate


def test_int8_batch_through_the_graph_equals_frames(served):
    _, port = served("tpu4b2", 2, 32, 64)
    frames = np.random.default_rng(9).integers(0, 256, (3, 32, 64, 4), np.uint8)
    batch = pel.make_pretrained_batch_upscaler(32, 64, 64, 128, prefer="quality", device="cpu")(frames)
    assert batch.shape == (3, 64, 128, 4)
    for i in range(3):
        assert torch.equal(batch[i], port(frames[i]))


@pytest.mark.parametrize("arch, upscale, convs", [("tpu4b2", 2, 8), ("tpu4b1", 2, 6), ("tpu4", 4, 8)])
def test_int8_serving_counts_its_convs(arch, upscale, convs):
    """With io scales (tpu4b2, tpu4b1) head, blocks, trunk, tail and base go
    through the int8-grid conv; without (tpu4) the head through the bf16
    conv and the base through the fp32 GEMMs."""
    model, _ = pel.load_model(arch, upscale)
    calls = {"q": [], "bf16": []}

    def spy_q(*args):
        calls["q"].append(tuple(args[0].shape))
        return cc.conv3x3_q(*args)

    def spy(*args):
        calls["bf16"].append(tuple(args[0].shape))
        return cc.conv3x3(*args)

    fs = pel.make_serving_fn_fused(model, 32, 64, "cpu", conv=spy,
                                   quant_scales=pel.load_act_scales(arch, upscale), conv_q=spy_q)
    assert fs.quantized and len(calls["q"]) == 0
    fs(torch.zeros((2, 32, 64, 4), dtype=torch.uint8))
    assert len(calls["q"]) == convs == fs.convs_per_frame - (arch == "tpu4")
    assert len(calls["bf16"]) == (arch == "tpu4")
    if arch != "tpu4":
        assert calls["q"][-1] == (2, 10, 18, 128)  # the base: SAME over the edge-padded input
    assert all(s == (2, 8, 16, 128) for s in calls["q"][: convs - (arch != "tpu4")])


@pytest.mark.parametrize("prefer", ["ultra", "quality", "performance"])
@pytest.mark.parametrize("sizes", [(32, 64, 64, 128), (32, 64, 128, 256), (16, 32, 64, 128)])
def test_pretrained_picks_match_jax(prefer, sizes):
    """For each ladder and scale the port serves JAX `_build_pretrained`'s
    (arch, step, quantized): quality x2 tpu4b2 int8 with io, x4 tpu4 int8;
    performance x2 tpu4b1 int8 with io, x4 tpu4 int8; ultra bf16."""
    in_h, in_w, out_h, out_w = sizes
    stages = el.scale_to_stages(in_h, out_h)
    jfn = el._build_pretrained(in_h, in_w, out_h, out_w, jnp.bfloat16, stages, prefer)
    port = pel.make_pretrained_upscaler(*sizes, prefer=prefer, device="cpu")
    want_step = etrain.load_checkpoint(stages, jfn.arch)[1]
    assert (port.arch, port.step, port.quantized) == (jfn.arch, want_step, jfn.quantized)
    assert port.quantized == (prefer != "ultra")


def test_fused_trunk_serves_bf16_only():
    model, _ = pel.load_model("tpu4b2", 2)
    with pytest.raises(ValueError, match="bf16 only"):
        pel.FusedServing(model, 32, 64, "cpu", trunk_impl="fused",
                         quant_scales=pel.load_act_scales("tpu4b2", 2))
    with pytest.raises(ValueError, match="bf16 only"):
        pel.make_pretrained_upscaler(32, 64, 64, 128, prefer="quality", device="cpu", trunk_impl="fused")


def test_conv3x3_q_wrapper(rng):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; the launcher refuses a CPU tensor; the checks name the operand."""
    xq = torch.from_numpy(rng.integers(-127, 128, (1, 5, 7, 128)).astype(np.float32)).to(torch.bfloat16)
    kq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 128, 128)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.full((128,), 1e-3)
    cc.reset_launches()
    out = cc.conv3x3_q(xq, kq, scale)
    assert cc.launches == {"conv3x3": 0, "conv3x3_q": 0}
    assert torch.equal(out, cc.conv3x3_q_plain(xq, kq, scale, None, False))
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        cc._launch_q(xq, kq, scale, None, False)
    with pytest.raises(TypeError, match="scale: expected a float32"):
        cc.conv3x3_q(xq, kq, scale.double())
    with pytest.raises(ValueError, match=r"b: expected \[128\]"):
        cc.conv3x3_q(xq, kq, scale, torch.zeros(64))
    with pytest.raises(ValueError, match=r"scale: expected \[128\]"):
        cc.conv3x3_q(xq, kq, scale[:64].contiguous())
    with pytest.raises(TypeError, match="b: expected a float32"):
        cc.conv3x3_q(xq, kq, scale, torch.zeros(128, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="x: expected a bfloat16"):
        cc.conv3x3_q(xq.float(), kq, scale)
