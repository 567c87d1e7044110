"""Every learned request the JAX ladder serves, on the port (CPU: the conv
wrapper runs its plain version): the padded-width conv, the sparse base, the
stride-8 graphs, ESRGANLite, the committed weights of the stride-2 arch and
of ESRGANLite, and the whole ladder — `arch` and the served bytes against
the JAX package's `make_pretrained_upscaler` on the same request."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.models import esrgan_lite as el
from nu_scaler_tpu.models import train as etrain
from nu_scaler_tpu_torch.kernels import conv_cuda as cc
from nu_scaler_tpu_torch.models import esrgan_lite as pel

LADDERS = ("ultra", "quality", "performance")
# (in h, in w, out h, out w): a frame only stride 2 divides at x2, x1.5 and
# x3 (non-exact ratios), odd sides, x4 with no stride-2 x4 weights, and x8
GRID = [(30, 62, 60, 124), (32, 64, 48, 96), (32, 64, 96, 192), (31, 63, 62, 126),
        (30, 62, 120, 248), (32, 64, 256, 512)]


def psnr_rgb(a: np.ndarray, b: np.ndarray) -> float:
    d = a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


@pytest.fixture(scope="module", autouse=True)
def cached_restores():
    """JAX's ladder restores orbax checkpoints on every build (about 1 s
    each); the same restores, cached for this module."""
    original = etrain.load_checkpoint
    etrain.load_checkpoint = functools.lru_cache(maxsize=None)(original)
    yield
    etrain.load_checkpoint = original


def _flat(tree, prefix=""):
    if "params" in tree and not prefix:
        tree = tree["params"]
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val, np.float32)
    return out


def _assert_bytes_close(got: np.ndarray, want: np.ndarray) -> None:
    """The ladder's bound: ≥ 45 dB RGB, mean |d| < 1 LSB, alpha within 1."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert psnr_rgb(got, want) >= 45.0
    assert d[..., :3].mean() < 1.0
    assert d[..., 3].max() <= 1


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin, cout", [(16, 64), (64, 64), (3, 32), (32, 128), (32, 3), (12, 48),
                                       (48, 192), (192, 192), (64, 768)])
@pytest.mark.parametrize("relu, round_sum", [(False, True), (True, False)])
def test_padded_conv_equals_unpadded_plain(cin, cout, relu, round_sum):
    """`conv3x3_padded` on weights zero-padded to the kernel's widths equals
    the plain conv at the real widths, bit for bit: the padded lanes add +0
    to each fp32 sum and the padded outputs are sliced off."""
    rng = np.random.default_rng(cin * 1000 + cout)
    x = torch.from_numpy(rng.standard_normal((2, 9, 13, cin)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(0.2 * rng.standard_normal((3, 3, cin, cout)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).bfloat16()
    kp, bp = cc.pad_weights(k.float().numpy(), b.float().numpy())
    assert kp.shape == (3, 3, cc.lanes(cin), cc.lanes(cout)) and bp.shape == (cc.lanes(cout),)
    kp, bp = torch.from_numpy(kp).bfloat16(), torch.from_numpy(bp).bfloat16()
    want = cc.conv3x3_plain(x, k, b, relu, round_sum)
    for fn in (cc.conv3x3_padded, cc.conv3x3_padded_plain):
        got = fn(x, kp, bp, cout, relu, round_sum)
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("c, upscale, stride", [(4, 2, 8), (3, 2, 8), (4, 4, 8), (3, 4, 8), (4, 2, 4)])
@pytest.mark.parametrize("domain", ["raw", "unit"])
def test_sparse_base_equals_jax_bf16(c, upscale, stride, domain):
    """The sparse base in bf16 equals JAX's (`esrgan_lite.py:1064-1069`, its
    terms and its roundings), on the raw 0..255 s2d the fused graph feeds it
    and on the [0, 1] s2d of the model's forward; in fp32 it equals the
    dense base within 1e-6."""
    rng = np.random.default_rng(c * 100 + upscale * 10 + stride)
    x = rng.integers(0, 256, (2, 5, 7, stride * stride * c)).astype(np.float32)
    if domain == "unit":
        x = x / np.float32(255.0)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    center, terms = el._sparse_base_terms(c, upscale, stride)

    def jax_base(s2d):
        base = jnp.einsum("nhwi,io->nhwo", s2d, jnp.asarray(center, s2d.dtype))
        for oy, ox, a_m, b_m in terms:
            red = jnp.einsum("nhwi,ik->nhwk", el._shift_edge_nhwc(s2d, oy, ox), jnp.asarray(a_m, s2d.dtype))
            base = base + jnp.einsum("nhwk,ko->nhwo", red, jnp.asarray(b_m, s2d.dtype))
        return base

    want = np.asarray(jax.jit(jax_base)(xj).astype(jnp.float32))
    got = pel.sparse_base(torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16(), c, upscale, stride)
    assert got.dtype == torch.bfloat16 and np.array_equal(got.float().numpy(), want)
    x32 = torch.from_numpy(x)
    assert torch.allclose(pel.sparse_base(x32, c, upscale, stride), pel.dense_base(x32, c, upscale, stride),
                          atol=1e-6, rtol=0)


@pytest.mark.parametrize("features, upscale, blocks", [(192, 2, 3), (192, 4, 1), (128, 2, 1)])
@pytest.mark.parametrize("ratio", ["exact", "x0.75"])
def test_stride8_graphs_match_jax(features, upscale, blocks, ratio):
    """A flax-initialised `ESRGANLiteTPU(stride=8, base_impl="sparse")`:
    the port's `make_serving_fn` (the fused graph at the exact ratio, the
    unfused one at 3/4 of it) against JAX's on the same parameters and
    seeded noise frame: ≥ 45 dB RGB, mean < 1 LSB, alpha within 1 LSB.
    Measured: 69.9 dB to equal bytes, mean ≤ 0.0066 LSB, alpha ≤ 1."""
    h, w = 32, 64
    model = el.ESRGANLiteTPU(upscale=upscale, stride=8, features=features, blocks=blocks,
                             base_impl="sparse")
    params = model.init(jax.random.PRNGKey(features + upscale), jnp.zeros((1, h, w, 3), jnp.float32))
    port = pel.ESRGANLiteTPU(features=features, blocks=blocks, upscale=upscale, stride=8,
                             base_impl="sparse")
    port.load_state_dict(pel.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    oh, ow = (h * upscale, w * upscale) if ratio == "exact" else (h * upscale * 3 // 4, w * upscale * 3 // 4)
    serving = pel.make_serving_fn(port, h, w, oh, ow, "cpu")
    assert isinstance(serving, pel.FusedServing if ratio == "exact" else pel.UnfusedServing)
    rng = np.random.default_rng(features * upscale + oh)
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    want = np.asarray(el.make_serving_fn(model, params, h, w, oh, ow)(jnp.asarray(img)))
    got = serving(torch.from_numpy(img[None]))[0].numpy()
    _assert_bytes_close(got, want)


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_lite_forward_matches_flax(stages, dtype):
    """`ESRGANLite` with `params_from_flax` of a flax init against
    `model.apply`: fp32 within 1e-5 (measured ≤ 1.02e-6); bf16 (parameters
    and input cast) ≥ 45 dB after u8 packing."""
    h, w = 12, 20
    model, params = el.init_params(7, stages)
    port = pel.ESRGANLite(stages=stages)
    port.load_state_dict(pel.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    x = np.random.default_rng(stages).random((1, h, w, 3), np.float32)
    if dtype == "f32":
        want = np.asarray(model.apply(params, jnp.asarray(x)))
        got = port(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (1, h * 2**stages, w * 2**stages, 3)
        assert np.abs(got - want).max() < 1e-5
    else:
        p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
        want = np.asarray(model.apply(p16, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        got = port.to(torch.bfloat16)(torch.from_numpy(x)).float().numpy()

        def u8(v):
            return np.clip(np.round(v * 255.0), 0, 255).astype(np.uint8)

        assert psnr_rgb(u8(got), u8(want)) >= 45.0


# ---------------------------------------------------------------------------
# the committed weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch, upscale, step", [("tpu", 2, 12000), ("lite", 2, 6000), ("lite", 4, 0),
                                                 ("lite", 8, 0)])
def test_committed_weights_equal_jax(arch, upscale, step):
    """The npz under nu_scaler_tpu_torch/weights/ equals, bit for bit and
    key for key, what the JAX ladder serves: the orbax restore at the served
    step, or for ESRGANLite at x4 and x8 (no checkpoint) `get_params`'s
    seed-0 `init_params(0, stages)`; the sidecar says which."""
    stages = int(np.log2(upscale))
    if step:
        params, got_step = etrain.load_checkpoint(stages, arch)
        assert got_step == step
    else:
        assert etrain.load_checkpoint(stages) is None
        params = el.init_params(0, stages)[1]
    tree, meta = pel.load_weights(arch, upscale)
    assert (meta["arch"], meta["upscale"], meta["step"], meta["stages"]) == (arch, upscale, step, stages)
    assert meta.get("init") == (None if step else "flax seed 0")
    want, got = _flat(params), _flat(tree)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key].view(np.uint32), want[key].view(np.uint32)), key
    model, _ = pel.load_model(arch, upscale)
    assert model.upscale == upscale
    assert isinstance(model, pel.ESRGANLite if arch == "lite" else pel.ESRGANLiteTPU)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefer", LADDERS)
@pytest.mark.parametrize("sizes", GRID)
def test_ladder_grid_matches_jax(prefer, sizes):
    """Each ladder at each size: the port's `arch` equals JAX's `fn.arch`,
    and its bytes on a seeded noise frame (random alpha) meet ≥ 45 dB RGB,
    mean |d| < 1 LSB and alpha within 1 LSB against JAX's. Measured on these
    seeds: the stride-2 tpu at x2 bit-equal (30×62); tpu4b2 / tpu4b1 at
    x1.5 61.5–61.8 dB, mean ≤ 0.046; tpu4 at x3 80.6 dB; ESRGANLite 67.3
    (x2, odd sides), 78.1 (x4) and 82.0 dB (x8), mean ≤ 0.012; alpha ≤ 1
    LSB everywhere (the fp32 resize's sums)."""
    h, w, oh, ow = sizes
    jfn = el.make_pretrained_upscaler(h, w, oh, ow, prefer=prefer)
    port = pel.make_pretrained_upscaler(h, w, oh, ow, prefer=prefer, device="cpu")
    assert port.arch == jfn.arch
    rng = np.random.default_rng(h * w + oh)
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    _assert_bytes_close(port(img).numpy(), np.asarray(jfn(jnp.asarray(img))))


@pytest.mark.parametrize("prefer, sizes, arch, jax_quantized", [
    ("quality", (32, 64, 48, 96), "tpu4b2", True),
    ("performance", (32, 64, 48, 96), "tpu4b1", True),
    ("quality", (32, 64, 96, 192), "tpu4", True),
    ("ultra", (32, 64, 48, 96), "tpu4b2", False),
    ("quality", (32, 64, 64, 128), "tpu4b2", True),
])
def test_quantized_flag_on_the_unfused_branch(prefer, sizes, arch, jax_quantized):
    """JAX sets ``fn.quantized`` whenever the checkpoint's scales match,
    also on the non-exact branch, which ignores them and serves bf16
    (`esrgan_lite.py:632-633,648,1102-1103`); the port serves the same bf16
    bytes there and reports False. At the exact ratio both serve int8."""
    h, w, oh, ow = sizes
    jfn = el.make_pretrained_upscaler(h, w, oh, ow, prefer=prefer)
    port = pel.make_pretrained_upscaler(h, w, oh, ow, prefer=prefer, device="cpu")
    assert (jfn.arch, jfn.quantized) == (arch, jax_quantized)
    exact = (oh, ow) == (2 * h, 2 * w)
    assert (port.arch, port.quantized) == (arch, exact and jax_quantized)
    assert isinstance(port.serving, pel.FusedServing if exact else pel.UnfusedServing)


@pytest.mark.parametrize("call, prefer", [("default", None), ("unknown", "bogus"), ("batch", None),
                                          ("fast", None)])
def test_entry_points_match_jax_defaults(call, prefer):
    """`make_pretrained_upscaler` and `make_pretrained_batch_upscaler`
    default to "quality" as JAX's do, an unknown `prefer` serves "quality"
    (`esrgan_lite.py:484-485`), and `make_fast_upscaler` is the
    "performance" ladder: the same arch and bytes as JAX's call made with
    the same arguments (int8 at this exact ratio: bit-equal to JAX run op by
    op, 45.8–54.9 dB against the jitted graph, `tests/test_torch_int8.py`)."""
    h, w, oh, ow = 32, 64, 64, 128
    kw = {} if prefer is None else {"prefer": prefer}
    if call == "batch":
        jfn = el.make_pretrained_batch_upscaler(h, w, oh, ow, **kw)
        port = pel.make_pretrained_batch_upscaler(h, w, oh, ow, device="cpu", **kw)
    elif call == "fast":
        jfn = el.make_fast_upscaler(h, w, oh, ow)
        port = pel.make_fast_upscaler(h, w, oh, ow, device="cpu")
    else:
        jfn = el.make_pretrained_upscaler(h, w, oh, ow, **kw)
        port = pel.make_pretrained_upscaler(h, w, oh, ow, device="cpu", **kw)
    assert port.arch == jfn.arch == ("tpu4b1" if call == "fast" else "tpu4b2")
    assert port.quantized == jfn.quantized is True
    rng = np.random.default_rng(17)
    frames = rng.integers(0, 256, (2, h, w, 4), np.uint8)
    if call == "batch":
        got, want = port(frames).numpy(), np.asarray(jfn(jnp.asarray(frames)))
        for g, wv in zip(got, want):
            _assert_bytes_close(g, wv)
    else:
        _assert_bytes_close(port(frames[0]).numpy(), np.asarray(jfn(jnp.asarray(frames[0]))))


@pytest.mark.parametrize("sizes", [(30, 62, 60, 124), (32, 64, 48, 96), (31, 63, 62, 126)])
def test_batch_through_the_graph_equals_frames(sizes):
    """The batch upscaler takes the batch through the graph in one pass (the
    stride-2 fused graph, the unfused one, ESRGANLite), frame for frame the
    single-frame bytes, as JAX's vmap does."""
    h, w, oh, ow = sizes
    frames = np.random.default_rng(h).integers(0, 256, (3, h, w, 4), np.uint8)
    batch = pel.make_pretrained_batch_upscaler(h, w, oh, ow, "ultra", "cpu")(frames)
    single = pel.make_pretrained_upscaler(h, w, oh, ow, "ultra", "cpu")
    assert batch.shape == (3, oh, ow, 4)
    for i in range(3):
        assert torch.equal(batch[i], single(frames[i]))


@pytest.mark.parametrize("sizes", [(30, 62, 60, 124), (32, 64, 48, 96)])
def test_fused_trunk_on_padded_widths(sizes):
    """`trunk_impl="fused"` serves the stride-2 arch (its 16-lane head, 64
    features and 64-phase tail padded to 128) and the unfused graph, with
    the bytes of "layers"; ESRGANLite's stages are not the trunk's chain,
    and it raises ValueError naming its widths."""
    h, w, oh, ow = sizes
    fused = pel.make_pretrained_upscaler(h, w, oh, ow, "ultra", "cpu", "fused")
    layers = pel.make_pretrained_upscaler(h, w, oh, ow, "ultra", "cpu")
    assert fused.serving.trunk_impl == "fused" and fused.arch == layers.arch
    img = np.random.default_rng(5).integers(0, 256, (h, w, 4), np.uint8)
    assert torch.equal(fused(img), layers(img))
    with pytest.raises(ValueError, match="32-feature"):
        pel.make_pretrained_upscaler(31, 63, 62, 126, "ultra", "cpu", "fused")


def test_conv_counts_and_widths_of_the_new_graphs():
    """Launches per call and the padded widths the conv sees: the stride-2
    graph's 9 convs at 128 lanes; ESRGANLite x2's 12 (head, 8 block convs,
    trunk, one up conv, tail); x16 has no weights and raises ValueError."""
    seen = []

    def spy(x, k, b, relu, round_sum):
        seen.append((x.shape[-1], k.shape[-1]))
        return cc.conv3x3(x, k, b, relu, round_sum)

    tpu, _ = pel.load_model("tpu", 2)
    fs = pel.make_serving_fn(tpu, 30, 62, 60, 124, "cpu", conv=spy)
    fs(torch.zeros((1, 30, 62, 4), dtype=torch.uint8))
    assert fs.convs_per_frame == len(seen) == 9 and set(seen) == {(128, 128)}
    seen.clear()
    lite, _ = pel.load_model("lite", 2)
    us = pel.make_serving_fn(lite, 31, 63, 62, 126, "cpu", conv=spy)
    us(torch.zeros((1, 31, 63, 4), dtype=torch.uint8))
    assert us.convs_per_frame == len(seen) == 12 and all(c % 128 == 0 for pair in seen for c in pair)
    with pytest.raises(ValueError, match="x16"):
        pel.make_pretrained_upscaler(16, 16, 256, 256, device="cpu")


def test_no_request_raises_item9():
    """Nothing in the model module raises NotImplementedError any more."""
    src = open(pel.__file__).read()
    assert "NotImplementedError" not in src and "item 9" not in src
