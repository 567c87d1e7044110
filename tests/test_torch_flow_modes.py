"""The port's interpolation modes "flow" and "flow_exact"
(nu_scaler_tpu_torch.ops.interpolate and the API) against the JAX package's,
on the CPU: the goldens, the flow stages function by function, then the
modes through the factories, `interpolate_frames` and
`WgpuFrameInterpolator`.

The same seeded numpy inputs go to both packages. Tolerances:

* the numpy goldens (copies): equal.
* `gaussian_blur`, `warp_blend` (same flow), `flow_refine` and
  `horn_schunck` run op by op (`jax.disable_jit`): equal. Against JAX's
  compiled loops, which may contract products and sums into FMAs:
  `flow_refine` ≤ 1e-4 on random flow of ±2 px and random luma.
* `downsample2x`, `build_pyramid`: ≤ 1e-6 (the 2×2 mean's sum order).
* `compute_flow`, `compute_flow_fast`: ≤ 1e-3 px, the flow stage's bound
  (tests/test_torch_flow.py); measured ~2e-6 px at 48×256 (the bilinear
  flow upsample and the luma pyramid sum in another order).
* the modes' mid frames: ≤ 1 LSB against `make_interpolator`, the share of
  differing bytes ≤ 1%; "flow_exact" equal to JAX run op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nu_scaler_core as nsc
from nu_scaler_tpu.kernels import reference as jref
from nu_scaler_tpu.kernels import soft_warp_pallas as jswp
from nu_scaler_tpu.ops import interpolate as J
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch import core as pc
from nu_scaler_tpu_torch.kernels import reference as pref
from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
from nu_scaler_tpu_torch.ops import interpolate as P

H, W = 48, 256


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _lsb(a, b) -> np.ndarray:
    return np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))


def _scene(h: int, w: int, offset: float) -> np.ndarray:
    """A bright blob sliding right over a textured background, so that the
    flow has gradients everywhere."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    blob = 230.0 * np.exp(-(((xx - 60.0 - offset) / 14.0) ** 2 + ((yy - h / 2) / (h / 5)) ** 2))
    img = np.zeros((h, w, 4), np.uint8)
    for c in range(3):
        img[..., c] = np.clip(20.0 + blob + 20.0 * np.sin(yy * 0.3 + c) + 15.0 * np.sin(xx * 0.21 + c),
                              0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


@pytest.fixture(scope="module")
def pair():
    return _scene(H, W, 0.0), _scene(H, W, 5.0)


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------


def _golden_cases():
    rng = np.random.default_rng(5)
    img = rng.random((20, 28, 4)).astype(np.float32)
    u8 = rng.integers(0, 256, (20, 28, 4), np.uint8)
    u8b = rng.integers(0, 256, (20, 28, 4), np.uint8)
    l1, l2 = rng.random((20, 28)).astype(np.float32), rng.random((20, 28)).astype(np.float32)
    flow = (rng.standard_normal((20, 28, 2)) * 3).astype(np.float32)
    small = (rng.standard_normal((10, 14, 2))).astype(np.float32)
    xs = (rng.random((20, 28)) * 40 - 6).astype(np.float32)
    ys = (rng.random((20, 28)) * 30 - 5).astype(np.float32)
    return {
        "gaussian_blur_ref": (img,),
        "downsample2x_ref": (img,),
        "luminance_ref": (img,),
        "horn_schunck_step_ref": (l1, l2, flow, 0.1),
        "flow_upsample_ref": (small, 20, 28),
        "flow_refine_step_ref": (l1, l2, flow, 0.1),
        "_sample_bilinear_clamp": (img, xs, ys),
        "warp_blend_ref": (u8, u8b, flow, 0.3),
        "bilinear_ref": (u8, 37, 61),
    }


@pytest.mark.parametrize("name", sorted(_golden_cases()))
def test_flow_goldens_equal_jax(name):
    args = _golden_cases()[name]
    np.testing.assert_array_equal(getattr(pref, name)(*args), getattr(jref, name)(*args))


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------


def test_gaussian_blur_downsample_pyramid(rng):
    img = rng.random((2, 37, 53, 4)).astype(np.float32)  # a lead dim, odd sides
    np.testing.assert_array_equal(P.gaussian_blur(_t(img)).numpy(), np.asarray(J.gaussian_blur(img)))
    np.testing.assert_allclose(P.gaussian_blur(_t(img[0])).numpy(), pref.gaussian_blur_ref(img[0]),
                               atol=1e-6)
    assert _max_abs(P.downsample2x(_t(img)), J.downsample2x(img)) <= 1e-6
    assert _max_abs(P.downsample2x(_t(img[0])), pref.downsample2x_ref(img[0])) <= 1e-6
    got, want = P.build_pyramid(_t(img[0]), 4), J.build_pyramid(jnp.asarray(img[0]), 4)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (37, 53, 4), (18, 26, 4), (9, 13, 4), (4, 6, 4)]
    assert max(_max_abs(g, w) for g, w in zip(got, want)) <= 1e-6
    assert len(P.build_pyramid(_t(img[0, :6, :6]), 4)) == len(J.build_pyramid(img[0, :6, :6], 4)) == 2


@pytest.mark.parametrize("subpixel", [True, False])
def test_flow_refine_matches_jax(rng, pair, subpixel):
    """Op by op on random luma and flow: equal. Against the compiled loop on
    the scene's luma and a smooth flow of up to 3 px: ≤ 1e-4."""
    l1, l2 = rng.random((H, W)).astype(np.float32), rng.random((H, W)).astype(np.float32)
    f0 = (rng.standard_normal((H, W, 2)) * 2).astype(np.float32)
    got = P.flow_refine(_t(l1), _t(l2), _t(f0), 3, subpixel=subpixel).numpy()
    with jax.disable_jit():
        want = np.asarray(J.flow_refine(*(jnp.asarray(x) for x in (l1, l2, f0)), 3, subpixel=subpixel))
    np.testing.assert_array_equal(got, want)
    la, lb = (pref.luminance_ref(x.astype(np.float32) / 255.0) for x in pair)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = np.stack([3.0 * np.sin(xx / 40.0), 2.0 * np.cos(yy / 20.0)], -1).astype(np.float32)
    got = P.flow_refine(_t(la), _t(lb), _t(smooth), 4, subpixel=subpixel).numpy()
    want = J.flow_refine(*(jnp.asarray(x) for x in (la, lb, smooth)), 4, subpixel=subpixel)
    assert _max_abs(got, want) <= 1e-4


def test_flow_refine_step_matches_golden(rng):
    l1, l2 = rng.random((20, 28)).astype(np.float32), rng.random((20, 28)).astype(np.float32)
    f0 = (rng.standard_normal((20, 28, 2)) * 2).astype(np.float32)
    got = P.flow_refine(_t(l1), _t(l2), _t(f0), 1, subpixel=False).numpy()
    np.testing.assert_allclose(got, pref.flow_refine_step_ref(l1, l2, f0, P.DEFAULT_ALPHA), atol=1e-4)


@pytest.mark.parametrize("lam", [0.1, 0.5])
def test_horn_schunck_lambda_matches_jax(rng, lam):
    l1, l2 = rng.random((20, 28)).astype(np.float32), rng.random((20, 28)).astype(np.float32)
    f0 = (rng.standard_normal((20, 28, 2))).astype(np.float32)
    got = P.horn_schunck(_t(l1), _t(l2), _t(f0), 5, lam).numpy()
    with jax.disable_jit():
        np.testing.assert_array_equal(got, np.asarray(J.horn_schunck(l1, l2, f0, 5, lam)))
    one = P.horn_schunck(_t(l1), _t(l2), _t(f0), 1, lam).numpy()
    np.testing.assert_allclose(one, pref.horn_schunck_step_ref(l1, l2, f0, lam), atol=1e-5)


@pytest.mark.parametrize("t", [0.5, 0.3])
def test_warp_blend_matches_jax_and_golden(rng, pair, t):
    a, b = pair
    flow = (rng.standard_normal((H, W, 2)) * 3).astype(np.float32)
    got = P.warp_blend(_t(a), _t(b), _t(flow), t).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.warp_blend(a, b, flow, t)))
    gold = pref.warp_blend_ref(a, b, flow, t)
    assert _lsb(got, gold).max() <= 1 and psnr(got, gold) >= 50.0
    # the sampler alone, far outside the frame: each corner clamped on its own
    xs = (rng.random((H, W)) * (W + 40) - 20).astype(np.float32)
    ys = (rng.random((H, W)) * (H + 20) - 10).astype(np.float32)
    img = rng.random((H, W, 3)).astype(np.float32)
    np.testing.assert_array_equal(P._sample_bilinear(_t(img), _t(xs), _t(ys)).numpy(),
                                  np.asarray(J._sample_bilinear(img, xs, ys)))


def test_compute_flow_matches_jax(pair):
    a, b = pair
    got = P.compute_flow(_t(a), _t(b)).numpy()
    assert got.shape == (H, W, 2)
    assert _max_abs(got, J.compute_flow(a, b)) <= 1e-3
    # the keyword knobs reach the stages
    kw = {"levels": 3, "coarse_iters": 8, "refine_iters": 2}
    got3 = P.compute_flow(_t(a), _t(b), **kw).numpy()
    assert _max_abs(got3, J.compute_flow(a, b, **kw)) <= 1e-3


@pytest.mark.parametrize("base_level, upsample", [(0, True), (1, True), (2, True), (2, False)])
def test_compute_flow_fast_signature_matches_jax(pair, base_level, upsample):
    a, b = pair
    got = P.compute_flow_fast(_t(a), _t(b), base_level=base_level, upsample=upsample).numpy()
    want = np.asarray(J.compute_flow_fast(a, b, base_level=base_level, upsample=upsample))
    assert got.shape == want.shape
    assert _max_abs(got, want) <= 1e-3


def test_flow_soft_tiles_unchanged_by_the_signature(pair):
    """flow_soft's tile motion is the tile mean of the base-level field that
    `upsample=False` returns, and the upsampled field is that field resized
    and scaled: the numbers flow_soft's callers got before."""
    a, b = pair
    base = P.compute_flow_fast(_t(a), _t(b), base_level=1, upsample=False)
    assert tuple(base.shape) == (H // 2, W // 2, 2)
    torch.testing.assert_close(P.flow_tiles_fast(_t(a), _t(b)), P._tile_mean(base, 4, 64) * 2.0,
                               rtol=0, atol=0)
    full = P.compute_flow_fast(_t(a), _t(b), base_level=1)
    torch.testing.assert_close(full, P.flow_upsample(base, H, W) * 2.0, rtol=0, atol=0)
    assert _max_abs(P.flow_tiles_fast(_t(a), _t(b)), J.flow_tiles_fast(a, b)) <= 1e-3


def test_block_warp_matches_jax(rng):
    img = rng.random((32, 256, 3)).astype(np.float32)
    off = (rng.standard_normal((32, 256, 2)) * 6).astype(np.float32)
    assert _max_abs(P.block_warp(_t(img), _t(off)), J.block_warp(img, off)) <= 1e-5
    # a uniform integer offset is an exact shift; a half pixel the mean of neighbours
    shift = np.tile(np.array([3.0, 2.0], np.float32), (32, 256, 1))
    out = P.block_warp(_t(img), _t(shift)).numpy()
    np.testing.assert_allclose(out[:-2, :-3], img[2:, 3:], atol=1e-5)
    half = np.tile(np.array([0.5, 0.0], np.float32), (32, 256, 1))
    out = P.block_warp(_t(img), _t(half)).numpy()
    np.testing.assert_allclose(out[:, :-1], 0.5 * (img[:, :-1] + img[:, 1:]), atol=1e-5)


def test_candidates_many_offsets_match_jax(rng):
    """K = 8 of more than 8 distinct tile offsets (with tied counts): the
    JAX bins in the JAX order, and the same nearest assignment."""
    tiles = (rng.integers(-6, 7, (24, 12, 2)) + 0.25).astype(np.float32)
    tiles[:4, :4] = [2.25, -1.75]  # one clear winner, then ties
    assert len({tuple(v) for v in tiles.reshape(-1, 2)}) > 8
    cy, cx, assign = swc.candidates(_t(tiles), P.WARP_K, P.WARP_RANGE)
    jy, jx, jassign = jswp._candidates(jnp.asarray(tiles), P.WARP_K, P.WARP_RANGE)
    np.testing.assert_array_equal(cy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(cx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))


@pytest.mark.parametrize("t", [0.5, 0.25])
def test_warp_blend_fast_matches_jax(rng, t):
    """The hard block warp on a field of more than 8 distinct tile offsets."""
    h, w = 64, 512
    a, b = _scene(h, w, 0.0), _scene(h, w, 7.0)
    tiles = (rng.integers(-5, 6, (h // 8, w // 128, 2)) + 0.4).astype(np.float32)
    flow = np.repeat(np.repeat(tiles, 8, axis=0), 128, axis=1)
    got = P.warp_blend_fast(_t(a), _t(b), _t(flow), t).numpy()
    want = np.asarray(J.warp_blend_fast(a, b, flow, t))
    d = _lsb(got, want)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    np.testing.assert_array_equal(got[..., 3], want[..., 3])  # alpha cross-faded


# ---------------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["flow", "flow_exact"])
@pytest.mark.parametrize("t", [0.5, 1.0 / 3.0])
def test_make_interpolator_matches_jax(pair, mode, t):
    a, b = pair
    got = P.make_interpolator(H, W, mode, "cpu")(_t(a), _t(b), t).numpy()
    want = np.asarray(J.make_interpolator(H, W, mode)(a, b, t))
    d = _lsb(got, want)
    print(f"{mode} t={t:.4f}: max {d.max()} LSB, {int((d > 0).sum())} bytes differ")
    assert got.shape == (H, W, 4) and d.max() <= 1 and (d > 0).mean() <= 0.01
    if mode == "flow_exact" and t == 0.5:
        with jax.disable_jit():
            np.testing.assert_array_equal(got, np.asarray(J.make_interpolator(H, W, mode)(a, b, t)))


def test_make_multi_interpolator_flow(pair):
    """One motion solve shared by every time: equal to the single calls,
    within 1 LSB of JAX's."""
    a, b = pair
    ts = (1.0 / 3.0, 2.0 / 3.0)
    got = P.make_multi_interpolator(H, W, ts, "flow", "cpu")(_t(a), _t(b)).numpy()
    single = P.make_interpolator(H, W, "flow", "cpu")
    for i, t in enumerate(ts):
        np.testing.assert_array_equal(got[i], single(_t(a), _t(b), t).numpy())
    want = np.asarray(J.make_multi_interpolator(H, W, ts, "flow")(a, b))
    assert got.shape == want.shape == (2, H, W, 4) and _lsb(got, want).max() <= 1
    # "flow_exact" has no multi-time form, in either package
    with pytest.raises(ValueError, match="unknown multi-interpolation mode"):
        P.make_multi_interpolator(H, W, ts, "flow_exact", "cpu")
    with pytest.raises(ValueError, match="unknown multi-interpolation mode"):
        J.make_multi_interpolator(H, W, ts, "flow_exact")


@pytest.mark.parametrize("mode", ["blend", "flow", "flow_exact"])
def test_interpolate_frames_matches_jax(pair, mode):
    a, b = pair
    got = P.interpolate_frames(a, b, 0.5, mode, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert _lsb(got.numpy(), J.interpolate_frames(a, b, 0.5, mode)).max() <= 1


def test_uniform_shift_flow_recovery():
    """tests/test_interpolate.py's analytic case on the port: a smooth
    pattern shifted by (+2, 0) px gives a positive mean x flow."""
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127.5 + 80 * np.sin(xx * (2 * np.pi / 24)) + 40 * np.sin(yy * (2 * np.pi / 32))
    a = np.zeros((h, w, 4), np.uint8)
    b = np.zeros((h, w, 4), np.uint8)
    for c in range(3):
        a[..., c] = np.clip(base, 0, 255).astype(np.uint8)
        b[..., c] = np.clip(np.roll(base, 2, axis=1), 0, 255).astype(np.uint8)
    a[..., 3] = b[..., 3] = 255
    flow = P.compute_flow(_t(a), _t(b), levels=3, coarse_iters=64, refine_iters=8).numpy()
    inner = flow[8:-8, 8:-8]
    assert inner[..., 0].mean() > 0.5 and abs(inner[..., 1].mean()) < 0.5
    fast = P.compute_flow_fast(_t(a[:48, :]), _t(b[:48, :]), levels=3).numpy()
    assert fast[8:-8, 8:-8, 0].mean() > 1.0 and abs(fast[8:-8, 8:-8, 1].mean()) < 0.5


def test_flow_modes_beat_blend_on_motion():
    """tests/test_interpolate.py's value test on the port: on a moving blob
    both flow modes beat the cross-fade against the true mid."""
    h, w = 48, 80
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def scene(offset):
        img = np.zeros((h, w, 4), np.uint8)
        blob = 230.0 * np.exp(-(((xx - 30.0 - offset) / 10.0) ** 2 + ((yy - 24.0) / 10.0) ** 2))
        for c in range(3):
            img[..., c] = np.clip(20.0 + blob, 0, 255).astype(np.uint8)
        img[..., 3] = 255
        return img

    a, mid, b = scene(0), scene(3), scene(6)
    p = {m: psnr(P.interpolate_frames(a, b, 0.5, m, device="cpu").numpy(), mid)
         for m in ("blend", "flow", "flow_exact")}
    assert p["flow"] > p["blend"] and p["flow_exact"] > p["blend"], p


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["flow", "flow_exact"])
def test_api_interpolate_py_matches_core(pair, mode):
    a, b = pair
    got = pc.WgpuFrameInterpolator(mode=mode, device="cpu").interpolate_py(a.tobytes(), b.tobytes(), W, H)
    want = nsc.WgpuFrameInterpolator(mode=mode).interpolate_py(a.tobytes(), b.tobytes(), W, H)
    assert len(got) == H * W * 4
    assert _lsb(np.frombuffer(got, np.uint8), np.frombuffer(want, np.uint8)).max() <= 1


def test_api_interpolate_multi_py_flow_equals_single_calls(pair):
    a, b = pair
    fi = pc.WgpuFrameInterpolator(mode="flow", device="cpu")
    outs = fi.interpolate_multi_py(a.tobytes(), b.tobytes(), W, H, times=(1 / 3, 2 / 3))
    assert [len(o) for o in outs] == [H * W * 4] * 2
    for o, t in zip(outs, (1 / 3, 2 / 3)):
        assert o == fi.interpolate_py(a.tobytes(), b.tobytes(), W, H, time_t=t)
    # flow_exact has no multi-time form: it serves flow_soft, as nu_scaler_core
    ex = pc.WgpuFrameInterpolator(mode="flow_exact", device="cpu")
    soft = pc.WgpuFrameInterpolator(mode="flow_soft", device="cpu")
    assert (ex.interpolate_multi_py(a.tobytes(), b.tobytes(), W, H)
            == soft.interpolate_multi_py(a.tobytes(), b.tobytes(), W, H))
