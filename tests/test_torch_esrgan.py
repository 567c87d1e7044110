"""The port's learned "ultra" tier (`nu_scaler_tpu_torch/models/esrgan_lite.py`)
against the JAX package's, on the CPU (the conv wrapper runs its plain
version): the network, the weight carrying, the committed weights, and the
served bytes against `make_serving_fn_fused(quant_scales=None)` and the
bench's twin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.models import esrgan_lite as el
from nu_scaler_tpu.models import train as etrain
from nu_scaler_tpu_torch.models import esrgan_lite as pel

SERVED = {2: (1, "tpu4b2", 76000), 4: (2, "tpu4", 52000)}  # upscale → (stages, arch, step)


def psnr_rgb(a: np.ndarray, b: np.ndarray) -> float:
    d = a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def to_u8(x01: np.ndarray) -> np.ndarray:
    return np.clip(np.round(np.asarray(x01, np.float32) * 255.0), 0, 255).astype(np.uint8)


def bench_frame(h: int, w: int) -> np.ndarray:
    """The bench input (`bench.make_input`) at h×w: the gradient pattern
    with a white box at rows 4/9..5/9, columns 1/3..19/48."""
    x = np.arange(w, dtype=np.uint64)
    y = np.arange(h, dtype=np.uint64)
    img = np.empty((h, w, 4), np.uint8)
    img[..., 0] = (x * 255 // w).astype(np.uint8)[None, :]
    img[..., 1] = (y * 255 // h).astype(np.uint8)[:, None]
    img[..., 2] = ((x[None, :] + y[:, None]) * 255 // (w + h)).astype(np.uint8)
    img[..., 3] = 255
    img[h * 4 // 9: h * 5 // 9, w // 3: w * 19 // 48, :3] = 255
    return img


@pytest.fixture(scope="module")
def restored():
    """The orbax restores of the two served checkpoints (about 4 s each)."""
    return {u: etrain.load_checkpoint(stages, arch) for u, (stages, arch, _) in SERVED.items()}


def _flat(tree, prefix=""):
    if "params" in tree and not prefix:
        tree = tree["params"]
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def test_helpers_equal_jax():
    for c, up, st in ((4, 2, 4), (4, 4, 4), (3, 2, 4), (3, 2, 2)):
        assert np.array_equal(pel._bilinear_base_kernel(c, up, st), el._bilinear_base_kernel(c, up, st))
    rng = np.random.default_rng(5)
    k = rng.standard_normal((3, 3, 48, 128)).astype(np.float32)
    assert np.array_equal(pel._expand_in_rgba(k, 4, 1 / 255.0), el._expand_in_rgba(k, 4, 1 / 255.0))
    k = rng.standard_normal((3, 3, 128, 192)).astype(np.float32)
    b = rng.standard_normal(192).astype(np.float32)
    for got, want in zip(pel._expand_out_rgba(k, b, 8, 255.0), el._expand_out_rgba(k, b, 8, 255.0)):
        assert np.array_equal(got, want)
    for h, oh in ((540, 2160), (1080, 2160), (100, 300), (64, 64)):
        assert pel.scale_to_stages(h, oh) == el.scale_to_stages(h, oh)
    assert pel.ARCH_LADDER == el._ARCH_LADDER


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_forward_matches_flax_apply(rng, dtype):
    """`params_from_flax` on a random-init flax ESRGANLiteTPU(stride=4,
    features=128, blocks=1); the port's forward against `model.apply` on the
    same input. bf16 (parameters and input cast, as tests/test_esrgan.py
    does): ≥ 45 dB after u8 packing (measured: every value equal). f32:
    within 1e-5 (measured 1.3e-6)."""
    h, w = 16, 32
    model = el.ESRGANLiteTPU(upscale=2, stride=4, features=128, blocks=1)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3), jnp.float32))
    x = rng.random((1, h, w, 3), np.float32)
    port = pel.ESRGANLiteTPU(features=128, blocks=1, upscale=2, stride=4)
    port.load_state_dict(pel.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    if dtype == "bf16":
        p_cast = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
        want = np.asarray(model.apply(p_cast, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        got = port.to(torch.bfloat16)(torch.from_numpy(x)).float().numpy()
        assert got.shape == want.shape == (1, 2 * h, 2 * w, 3)
        assert psnr_rgb(to_u8(got), to_u8(want)) >= 45.0
    else:
        want = np.asarray(model.apply(params, jnp.asarray(x)))
        got = port(torch.from_numpy(x)).numpy()
        assert np.max(np.abs(got - want)) < 1e-5
    ph = port(torch.from_numpy(x), phase_domain=True)
    assert ph.shape == (1, h // 4, w // 4, 8 * 8 * 3)


@pytest.mark.parametrize("upscale", [2, 4])
def test_committed_weights_equal_orbax_restore(restored, upscale):
    """The npz under nu_scaler_tpu_torch/weights/ equals the orbax restore
    at the served step, bit for bit, key for key; the sidecar names the
    model and step, and the module takes the tree."""
    params, step = restored[upscale]
    _, arch, want_step = SERVED[upscale]
    assert step == want_step
    tree, meta = pel.load_weights(arch, upscale)
    assert (meta["arch"], meta["upscale"], meta["step"]) == (arch, upscale, step)
    want, got = _flat(params), _flat(tree)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.float32
        assert np.array_equal(got[key].view(np.uint32), np.asarray(want[key], np.float32).view(np.uint32)), key
    assert meta["parameters"] == sum(a.size for a in want.values())
    model, _ = pel.load_model(arch, upscale)
    assert model.blocks == meta["model"]["blocks"] and model.stride == 4


@pytest.fixture(scope="module")
def served(restored):
    """(JAX serving fn, JAX twin, port upscaler) per (upscale, h, w)."""
    cache = {}

    def get(upscale, h, w):
        if (upscale, h, w) not in cache:
            stages, arch, _ = SERVED[upscale]
            params, _ = restored[upscale]
            kw = {a: k for a, k, _ in el._ARCH_LADDER["ultra"]}[arch]
            model = el.ESRGANLiteTPU(upscale=upscale, **kw)
            jfn = el.make_serving_fn_fused(model, params, h, w, quant_scales=None)
            twin = jax.jit(lambda x: model.apply(params, x))  # bench.py _twin_model_fn
            port = pel.make_pretrained_upscaler(h, w, upscale * h, upscale * w, "ultra", device="cpu")
            assert (port.arch, port.step, port.quantized) == (arch, SERVED[upscale][2], False)
            cache[(upscale, h, w)] = (jfn, twin, port)
        return cache[(upscale, h, w)]

    return get


@pytest.mark.parametrize("upscale, h, w", [(2, 32, 64), (2, 64, 128), (4, 32, 64)])
@pytest.mark.parametrize("alpha", ["opaque", "random"])
def test_served_matches_jax_serving(served, upscale, h, w, alpha):
    """The port's served bytes against JAX `make_serving_fn_fused(quant_scales
    =None)` on the same checkpoint and seeded noise frame: ≥ 45 dB RGB and
    mean |d| < 1 LSB (the bound of tests/test_esrgan.py:260-294); alpha equal
    for α ≡ 255, within 1 LSB for random α. Measured on these seeds (RGB is
    the same draw for both alphas): x2 32×64 59.16 dB, mean 0.074 LSB, max
    2; x2 64×128 55.04 dB, mean 0.152, max 6; x4 32×64 57.28 dB, mean 0.111,
    max 3; alpha equal in all. The remaining differences are the fp32 sums'
    order, which flips a bf16 rounding now and then; the flip travels
    through the net."""
    jfn, _, port = served(upscale, h, w)
    rng = np.random.default_rng(upscale * 1000 + h)
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    if alpha == "opaque":
        img[..., 3] = 255
    want = np.asarray(jfn(jnp.asarray(img)))
    got = port(img).numpy()
    assert got.shape == want.shape == (upscale * h, upscale * w, 4) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert psnr_rgb(got, want) >= 45.0
    assert d[..., :3].mean() < 1.0
    assert d[..., 3].max() <= (0 if alpha == "opaque" else 1)
    if alpha == "opaque":
        assert np.all(got[..., 3] == 255)


@pytest.mark.parametrize("upscale, h, w, gate", [(2, 64, 128, 42.0), (4, 32, 64, 40.0)])
def test_served_vs_bench_twin(served, upscale, h, w, gate):
    """The bench's fidelity gate (`bench.py` `_gate_esrgan_twin`: served
    bytes against the f32 model.apply, rounded to u8) on the bench frame:
    ≥ 42 dB at x2 (`psnr_esrgan_vs_twin_db`), ≥ 40 dB at x4. The port's own
    twin (its fp32 forward) equals the JAX twin within 1e-5 and gives the
    same reading. Measured: x2 54.15 dB, x4 53.38 dB, and JAX's served bytes
    read the same within 0.01 dB. On seeded noise the raw-domain bf16 graph
    reads 41.6–42.6 dB against the twin, JAX's and the port's alike (41.87
    and 41.86 dB at x2 64×128): the gate is the bench frame's."""
    jfn, twin, port = served(upscale, h, w)
    img = bench_frame(h, w)
    x01 = img[None, ..., :3].astype(np.float32) / 255.0
    want = np.asarray(twin(jnp.asarray(x01)))[0]
    got = port(img).numpy()
    assert psnr_rgb(got, to_u8(want)) >= gate
    model, _ = pel.load_model(SERVED[upscale][1], upscale)
    own = model(torch.from_numpy(x01))[0].numpy()
    assert np.max(np.abs(own - want)) < 1e-5
    assert psnr_rgb(got, to_u8(own)) >= gate
    assert abs(psnr_rgb(got, to_u8(want)) - psnr_rgb(np.asarray(jfn(jnp.asarray(img))), to_u8(want))) < 0.5


def test_batch_through_the_graph_equals_frames(served):
    _, _, port = served(2, 32, 64)
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (3, 32, 64, 4), np.uint8)
    batch = pel.make_pretrained_batch_upscaler(32, 64, 64, 128, "ultra", device="cpu")(frames)
    assert batch.shape == (3, 64, 128, 4)
    for i in range(3):
        assert torch.equal(batch[i], port(frames[i]))


def test_serving_counts_its_convs(served):
    _, _, x2 = served(2, 32, 64)
    _, _, x4 = served(4, 32, 64)
    assert x2.serving.convs_per_frame == 7 and x4.serving.convs_per_frame == 9
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return pel.conv_cuda.conv3x3(*args)

    fs = pel.make_serving_fn_fused(pel.load_model("tpu4b2", 2)[0], 32, 64, "cpu", conv=spy)
    fs(torch.zeros((2, 32, 64, 4), dtype=torch.uint8))
    assert len(calls) == 7 and all(s == (2, 8, 16, 128) for s in calls)


@pytest.mark.parametrize("prefer, sizes, arch", [
    ("ultra", (32, 64, 96, 192), "tpu4"),     # x3: the x4 net, resized
    ("ultra", (30, 62, 60, 124), "tpu"),      # stride 4 does not divide: the stride-2 arch
    ("ultra", (32, 64, 256, 512), "lite"),    # x8: ESRGANLite
    ("quality", (30, 62, 60, 124), "tpu"),
    ("performance", (30, 62, 60, 124), "tpu"),
])
def test_unported_requests_raise(prefer, sizes, arch):
    """The requests that raised before the rest of the ladder was ported
    now serve the JAX ladder's arch, u8 RGBA of the output size (their bytes
    against JAX's: tests/test_torch_esrgan_ladder.py)."""
    up = pel.make_pretrained_upscaler(*sizes, prefer=prefer, device="cpu")
    assert up.arch == arch == el.make_pretrained_upscaler(*sizes, prefer=prefer).arch
    out = up(np.zeros((sizes[0], sizes[1], 4), np.uint8))
    assert out.shape == (sizes[2], sizes[3], 4) and out.dtype == torch.uint8


@pytest.mark.parametrize("prefer, sizes, arch", [
    ("quality", (32, 64, 64, 128), "tpu4b2"),
    ("performance", (32, 64, 64, 128), "tpu4b1"),
])
def test_int8_ladder_requests_serve(prefer, sizes, arch):
    """The int8 ladders serve (they raised before their port): int8 with
    the head and base on the grid, u8 RGBA of the output size."""
    up = pel.make_pretrained_upscaler(*sizes, prefer=prefer, device="cpu")
    assert (up.arch, up.quantized) == (arch, True) and up.serving.q_head is not None
    out = up(np.zeros((sizes[0], sizes[1], 4), np.uint8))
    assert out.shape == (sizes[2], sizes[3], 4) and out.dtype == torch.uint8


def test_make_serving_fn_exact_ratio_only():
    """The fused graph serves only the exact ratio; another ratio serves the
    unfused branch; a frame the stride does not divide cannot take the
    fused graph's s2d (ValueError), as in JAX."""
    model, _ = pel.load_model("tpu4b2", 2)
    assert isinstance(pel.make_serving_fn(model, 32, 64, 64, 128, "cpu"), pel.FusedServing)
    assert isinstance(pel.make_serving_fn(model, 32, 64, 60, 120, "cpu"), pel.UnfusedServing)
    with pytest.raises(ValueError, match="stride 4"):
        pel.make_serving_fn(model, 30, 64, 60, 128, "cpu")
