"""The port's bilinear resize (`nu_scaler_tpu_torch/ops/image_resize.py`)
against `jax.image.resize(method="bilinear")` on the CPU: the weight
matrices, and the resize in fp32 and bf16, up and down, on one axis and on
both, at the learned tier's shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from nu_scaler_tpu_torch.ops.image_resize import image_resize, resize_weights

# (input shape, output shape): the learned tier's resizes (ESRGANLite's base,
# a net's output to a non-exact target, the alpha plane) and both axes
# changing in opposite directions
CASES = [
    ((1, 30, 62, 3), (1, 60, 124, 3)),     # x2 up, both axes (ESRGANLite's base)
    ((1, 32, 64, 3), (1, 256, 512, 3)),    # x8 up
    ((64, 128, 3), (48, 96, 3)),           # 0.75 down, both axes (x2 net → 1.5)
    ((128, 256, 3), (96, 192, 3)),         # 0.75 down (x4 net → 3)
    ((31, 63, 1), (62, 126, 1)),           # the alpha plane, odd sides
    ((40, 40, 3), (30, 30, 3)),            # square, down
    ((32, 64, 3), (64, 64, 3)),            # one axis, up
    ((32, 64, 3), (24, 64, 3)),            # one axis, down
    ((50, 20, 3), (25, 40, 3)),            # one down, one up
    ((2, 30, 62, 3), (2, 45, 93, 3)),      # x1.5 up, a batch
]


@pytest.mark.parametrize("n_in, n_out", [(30, 60), (64, 48), (5120, 3840), (683, 2732), (7, 3),
                                          (100, 300), (31, 62)])
def test_weights_equal_jax(n_in, n_out):
    """The weight matrix equals `compute_weight_mat` (triangle kernel,
    antialias) evaluated op by op, bit for bit: taps outside the input
    dropped, each output's weights renormalised."""
    want = np.asarray(jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                                jscale._fill_triangle_kernel, True))
    got = resize_weights(n_in, n_out)
    assert got.dtype == np.float32 and got.shape == (n_in, n_out)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    live = got.sum(axis=0) > 0
    assert np.allclose(got.sum(axis=0)[live], 1.0, atol=1e-6)


@pytest.mark.parametrize("shape_in, shape_out", CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resize_matches_jax(shape_in, shape_out, dtype):
    """fp32: within 1e-6 of `jax.image.resize` (measured 1.2e-7 at most: the
    sums' order); bf16: equal, each axis's contraction rounded to bf16 once
    in JAX's order of the two."""
    rng = np.random.default_rng(sum(shape_in) + sum(shape_out))
    x = rng.random(shape_in, np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(x).astype(jdt)
    want = np.asarray(jax.image.resize(xj, shape_out, method="bilinear").astype(jnp.float32))
    got = image_resize(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt), shape_out)
    assert got.dtype == tdt and tuple(got.shape) == shape_out
    got = got.float().numpy()
    if dtype == "f32":
        assert np.abs(got - want).max() <= 1e-6
    else:
        assert np.array_equal(got, want)


def test_resize_x15_one_axis_vs_float64():
    """A ×1.5 upscale of one axis (64 → 96): the port is within 1e-7 of the
    float64 contraction of the same weights. `jax.image.resize` jits its
    weight computation, and XLA's fused fp32 arithmetic moves the weights of
    this size by up to 1.9e-6 from the op-by-op ones (which the port
    equals), so JAX's result departs by as much (measured 1.79e-6): the
    bound against JAX here is that difference of its own weights."""
    rng = np.random.default_rng(4)
    x = rng.random((32, 64, 3), np.float32)
    got = image_resize(torch.from_numpy(x), (32, 96, 3)).numpy()
    ref = np.einsum("hwc,wo->hoc", x.astype(np.float64), resize_weights(64, 96).astype(np.float64))
    assert np.abs(got - ref).max() <= 1e-7
    jitted = np.asarray(jax.jit(lambda: jscale.compute_weight_mat(
        64, 96, 1.5, 0.0, jscale._fill_triangle_kernel, True))())
    w_gap = float(np.abs(jitted - resize_weights(64, 96)).max())
    want = np.asarray(jax.image.resize(jnp.asarray(x), (32, 96, 3), method="bilinear"))
    assert np.abs(got - want).max() <= 1e-6 + w_gap


def test_resize_only_changed_axes_and_identity():
    x = torch.arange(2 * 3 * 5 * 4, dtype=torch.float32).reshape(2, 3, 5, 4)
    assert torch.equal(image_resize(x, x.shape), x)
    y = image_resize(x, (2, 6, 5, 4))
    assert y.shape == (2, 6, 5, 4)
    # the batch and channel axes are not contracted
    assert torch.equal(image_resize(x[:1], (1, 6, 5, 4)), y[:1])
    with pytest.raises(ValueError, match="rank"):
        image_resize(x, (6, 5, 4))
    with pytest.raises(TypeError):
        image_resize(x.double(), (2, 6, 5, 4))
