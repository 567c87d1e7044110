"""The port's fused trunk (`nu_scaler_tpu_torch/kernels/trunk_cuda.py`) against
the JAX package's Pallas `make_trunk_fused` (interpret mode on the CPU), the
port's own layer chain, and the JAX serving graph, on the CPU: the wrapper
runs its plain version (the chain of `conv3x3_plain` calls)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.kernels.conv_pallas import make_trunk_fused as jax_make_trunk_fused
from nu_scaler_tpu.models import esrgan_lite as el
from nu_scaler_tpu_torch.kernels import conv_cuda as cc
from nu_scaler_tpu_torch.kernels import trunk_cuda as tc
from nu_scaler_tpu_torch.models import esrgan_lite as pel

SERVED = {2: ("tpu4b2", 2), 4: ("tpu4", 3)}  # upscale → (arch, blocks)


def psnr_rgb(a: np.ndarray, b: np.ndarray) -> float:
    d = a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _pallas_params(rng, blocks, cout, c=128):
    """The JAX test's parameters (tests/test_pallas_kernels.py:106-145):
    kernels in [−0.05, 0.05), biases in [−0.01, 0.01), fp32 numpy."""
    def mk(ci, co):
        return [rng.random((3, 3, ci, co), np.float32) * 0.1 - 0.05,
                rng.random((co,), np.float32) * 0.02 - 0.01]

    params = mk(c, c)
    for _ in range(blocks):
        params += mk(c, c) + mk(c, c)
    return params + mk(c, c) + mk(c, cout)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("h, w, blocks, cout", [
    (40, 48, 2, 256),   # the JAX test's shape
    (37, 52, 3, 1024),  # ragged: no strip or tile divides it; the x4 tail's width
])
def test_plain_matches_pallas_trunk(rng, h, w, blocks, cout):
    """Single rounding (`round_sum=False`) against the Pallas kernel on the
    same bf16 inputs: max |d| < 0.1 (the JAX test's bound) and ≤ 2 bf16 ulps
    of the output's largest magnitude. Measured: 1 ulp (0.0078) in both
    cases, 83% and 73% of values equal; each side sums in its own order."""
    x = rng.random((h, w, 128), np.float32) - 0.5
    params = _pallas_params(rng, blocks, cout)
    fn = jax_make_trunk_fused(h, w, 128, 128, cout, blocks, th=16)
    want = np.asarray(fn(jnp.asarray(x, jnp.bfloat16), tuple(jnp.asarray(p) for p in params)),
                      np.float32)
    got = tc.make_trunk_fused(h, w, 128, 128, cout, blocks)(_bf16(x)[None], [_bf16(p) for p in params])
    assert got.shape == (1, h, w, cout) and got.dtype == torch.bfloat16
    d = np.abs(got[0].float().numpy() - want)
    assert d.max() < 0.1
    assert d.max() <= 2 * float(cc.ulp_bf16(torch.tensor(np.abs(want).max())))
    assert (d == 0).mean() > 0.6


@pytest.mark.parametrize("upscale", [2, 4])
def test_plain_round_sum_equals_the_layer_chain(upscale):
    """`trunk_fused_plain(round_sum=True)` is the serving graph's layer chain
    on `conv3x3_plain`, bit for bit, on the committed weights."""
    arch, blocks = SERVED[upscale]
    model, _ = pel.load_model(arch, upscale)
    layers = pel.FusedServing(model, 32, 64, "cpu", conv=cc.conv3x3_plain)
    img = np.random.default_rng(upscale).integers(0, 256, (2, 32, 64, 4), np.uint8)
    x = layers.trunk_input(torch.from_numpy(img))[1]
    want = layers.run_trunk(x)
    assert want.shape == (2, 8, 16, layers.r * layers.r * 4)
    assert torch.equal(tc.trunk_fused_plain(x, layers.trunk_params, blocks, round_sum=True), want)
    assert not torch.equal(tc.trunk_fused_plain(x, layers.trunk_params, blocks), want)


@pytest.mark.parametrize("upscale", [2, 4])
def test_fused_serving_matches_layers_and_jax(upscale):
    """On the CPU, `trunk_impl="fused"` serves the bytes of "layers"; against
    JAX `make_serving_fn_fused(quant_scales=None)` on the same committed
    weights it reads ≥ 45 dB RGB with alpha equal, the bound
    tests/test_torch_esrgan.py holds the layered path to (measured here:
    x2 59.16 dB, x4 57.28 dB, the layered path's readings)."""
    arch, _ = SERVED[upscale]
    h, w = 32, 64
    fused = pel.make_pretrained_upscaler(h, w, upscale * h, upscale * w, "ultra", device="cpu",
                                         trunk_impl="fused")
    layers = pel.make_pretrained_upscaler(h, w, upscale * h, upscale * w, "ultra", device="cpu")
    assert fused.serving.trunk_impl == "fused" and layers.serving.trunk_impl == "layers"
    assert fused.arch == arch
    rng = np.random.default_rng(upscale * 1000 + h)
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    img[..., 3] = 255
    got = fused(img).numpy()
    assert np.array_equal(got, layers(img).numpy())
    tree, _ = pel.load_weights(arch, upscale)
    kw = {a: k for a, k, _ in el._ARCH_LADDER["ultra"]}[arch]
    jfn = el.make_serving_fn_fused(el.ESRGANLiteTPU(upscale=upscale, **kw), tree, h, w,
                                   quant_scales=None)
    want = np.asarray(jfn(jnp.asarray(img)))
    assert got.shape == want.shape == (upscale * h, upscale * w, 4)
    assert psnr_rgb(got, want) >= 45.0
    assert np.array_equal(got[..., 3], want[..., 3])
    batch = pel.make_pretrained_batch_upscaler(h, w, upscale * h, upscale * w, "ultra", device="cpu",
                                               trunk_impl="fused")
    frames = np.stack([img, np.roll(img, 3, axis=1)])
    assert torch.equal(batch(frames)[0], fused(img))


def test_trunk_impl_is_checked():
    model, _ = pel.load_model("tpu4b2", 2)
    with pytest.raises(ValueError, match="trunk_impl"):
        pel.FusedServing(model, 32, 64, "cpu", trunk_impl="conv")
    assert pel.make_serving_fn_fused(model, 32, 64, "cpu").trunk_impl == "layers"


def test_make_trunk_fused_needs_lane_multiples():
    assert tc.make_trunk_fused(40, 48, 64, 128, 256, 2) is None
    assert tc.make_trunk_fused(40, 48, 128, 96, 256, 2) is None
    assert tc.make_trunk_fused(40, 48, 128, 128, 200, 2) is None
    assert tc.make_trunk_fused(40, 48, 128, 128, 256, 2) is not None


def _small(rng, n=1, h=5, w=7, blocks=1, cout=128):
    x = _bf16(rng.standard_normal((n, h, w, 128), np.float32))
    return x, [_bf16(p) for p in _pallas_params(rng, blocks, cout)]


def test_wrapper_checks(rng):
    x, params = _small(rng)
    with pytest.raises(TypeError, match="bfloat16"):
        tc.trunk_fused(x.float(), params, 1)
    with pytest.raises(TypeError, match="bfloat16"):
        tc.trunk_fused(x, [params[0].float(), *params[1:]], 1)
    with pytest.raises(ValueError, match="contiguous"):
        tc.trunk_fused(x.permute(0, 2, 1, 3), params, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tc.trunk_fused(x, [params[0].transpose(0, 1), *params[1:]], 1)
    with pytest.raises(ValueError, match="expected 14 tensors"):
        tc.trunk_fused(x, params, 2)
    with pytest.raises(ValueError, match="HWIO"):
        tc.trunk_fused(x, [params[0][:, :, :64].contiguous(), *params[1:]], 1)
    with pytest.raises(ValueError, match="multiples of 128"):
        tc.trunk_fused(x[..., :64].contiguous(),
                       [params[0][:, :, :64].contiguous(), *params[1:]], 1)
    with pytest.raises(ValueError, match="blocks must be"):
        tc.trunk_fused(x, params, -1)
    with pytest.raises(ValueError, match=r"expected \[N, 5, 8, 128\]"):
        tc.make_trunk_fused(5, 8, 128, 128, 128, 1)(x, params)


def test_cpu_runs_plain_and_counts_no_launch(rng):
    x, params = _small(rng, n=2, blocks=1, cout=256)
    tc.reset_launches()
    assert torch.equal(tc.trunk_fused(x, params, 1, True), tc.trunk_fused_plain(x, params, 1, True))
    assert tc.launches == {"trunk_fused": 0}
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        tc._launch(x, params, 1, True)


def test_batch_is_per_image(rng):
    x, params = _small(rng, n=3, h=9, w=6, blocks=2, cout=128)
    out = tc.trunk_fused(x, params, 2)
    for i in range(3):
        assert torch.equal(out[i:i + 1], tc.trunk_fused(x[i:i + 1].contiguous(), params, 2))


def item_origin(p, layer: int, item: int) -> tuple[int, int, int, int]:
    """(image, y0, x0, n0) of work item `item` of `layer`, as the kernel
    decodes it: item = (image · tiles + tile) · (couts[layer] / 128) +
    channel tile, tiles row-major."""
    nct = p.couts[layer] // 128
    t, ct = divmod(item, nct)
    img, tile = divmod(t, p.tiles_h * p.tiles_w)
    ty, tx = divmod(tile, p.tiles_w)
    return img, ty * tc.TILE, tx * tc.TILE, ct * 128


def dealt(p, layer: int, block: int) -> range:
    """The items of `layer` that persistent block `block` computes, as the
    kernel deals them: every grid-th item of the layers' sequence from the
    block's own index on."""
    first = sum(p.items[:layer])
    return range((block - first) % p.grid, p.items[layer], p.grid)


# the learned grids (x2 tpu4b2, x4 tpu4; N = 1 and 4) and a ragged 27x40
PLAN_SHAPES = [(1, 270, 480, 2, 256), (4, 270, 480, 2, 256), (1, 135, 240, 3, 1024),
               (4, 135, 240, 3, 1024), (4, 27, 40, 2, 256), (1, 27, 40, 3, 1024)]


@pytest.mark.parametrize("n, h, w, blocks, cout", PLAN_SHAPES)
def test_plan_deals_every_item_once_and_covers_the_frame(n, h, w, blocks, cout):
    """Each layer's (image, tile, channel tile) items are dealt to the
    persistent blocks exactly once, every grid-th item of the layers'
    sequence to each, and each channel tile's tiles cover every position of
    every image exactly once (the overhang past the frame is the kernel's
    to mask)."""
    p = tc.plan(n, h, w, blocks, 128, cout, 132)
    t = tc.TILE
    assert t * t == 256
    for layer, c in enumerate(p.couts):
        first = sum(p.items[:layer])
        seen = np.concatenate([np.fromiter(dealt(p, layer, b), np.int64) for b in range(p.grid)])
        assert np.array_equal(np.sort(seen), np.arange(p.items[layer]))
        for b in (0, p.grid - 1):
            assert all((first + i) % p.grid == b for i in dealt(p, layer, b))
        cover = np.zeros((c // 128, n, p.tiles_h * t, p.tiles_w * t), np.int64)
        for item in range(p.items[layer]):
            img, y0, x0, n0 = item_origin(p, layer, item)
            assert y0 < h and x0 < w and n0 % 128 == 0
            cover[n0 // 128, img, y0:y0 + t, x0:x0 + t] += 1
        assert np.all(cover == 1)
        assert p.tiles_h * t - h < t and p.tiles_w * t - w < t


@pytest.mark.parametrize("n, h, w, blocks, cout", PLAN_SHAPES)
def test_plan_grid_flags_and_scratch(n, h, w, blocks, cout):
    """The grid is the SM count unless the layers have fewer items in all;
    a ready flag per (layer, image, tile) and per layer of every layer but
    the tail; three activation buffers of n·h·w·cmid; the tail's items are
    Cout / 128 times a layer's."""
    p = tc.plan(n, h, w, blocks, 128, cout, 132)
    d = tc.depth(blocks)
    tiles = n * -(-h // 16) * -(-w // 16)
    assert p.couts == (128,) * (d - 1) + (cout,)
    assert p.items == (tiles,) * (d - 1) + (tiles * cout // 128,)
    assert p.grid == min(132, (d - 1 + cout // 128) * tiles) and p.flags == (d - 1) * (tiles + 1)
    assert p.act_elems == n * h * w * 128
    assert tc.plan(n, h, w, blocks, 128, cout, 4).grid == 4


def test_pack_params_layout(rng):
    """Every layer repacked as the conv kernel takes its weights:
    packed[o, dy, dx, c] == k[dy, dx, c, o], contiguous."""
    _, params = _small(rng, blocks=1, cout=256)
    packed = tc.pack_params(params)
    assert len(packed) == tc.depth(1)
    for k, kp in zip(params[0::2], packed):
        assert kp.is_contiguous() and kp.shape == (k.shape[3], 3, 3, k.shape[2])
        assert torch.equal(kp, k.permute(3, 0, 1, 2))
        assert torch.equal(kp[5, 2, 1, 7], k[2, 1, 7, 5])


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library's name changes when a header its source includes changes,
    so a changed header is never served by a stale build."""
    from nu_scaler_tpu_torch.kernels import _build

    (tmp_path / "conv3x3.cu").write_text('#include <cuda_runtime.h>\n#include "core.cuh"\n')
    (tmp_path / "core.cuh").write_text('#pragma once\n#include "inner.cuh"\nint a;\n')
    (tmp_path / "inner.cuh").write_text("int b;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [f.name for f in _build.source_files("conv3x3")] == ["conv3x3.cu", "core.cuh", "inner.cuh"]
    first = _build.library_path("conv3x3")
    (tmp_path / "inner.cuh").write_text("int b, c;\n")
    second = _build.library_path("conv3x3")
    (tmp_path / "core.cuh").write_text('#pragma once\n#include "inner.cuh"\nint a2;\n')
    third = _build.library_path("conv3x3")
    assert len({first, second, third}) == 3
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith("libconv3x3_") for p in (first, third))


def test_ulp_tolerance_scales_with_the_output():
    plain = torch.tensor([[0.5, -200.0], [3.0, 0.0]], dtype=torch.bfloat16)
    assert float(tc.ulp_tolerance(plain)) == tc.TOL_ULPS * 1.0  # one ulp at 200 is 1
