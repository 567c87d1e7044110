"""The port's flow_soft path (nu_scaler_tpu_torch.ops.interpolate) against the
JAX package's, on the CPU: the flow stage function by function, then the
slice as a whole through the ops, the API and the live pipeline.

The same seeded numpy inputs go to both packages. Tolerances:

* constants and the pyramid step operator: equal.
* `resize_f32`, `build_luma_pyramid`, `horn_schunck`, `flow_upsample`,
  `block_warp_planar`: max |Δ| ≤ 1e-5 (on [0, 1] luma or pixels of flow):
  both sides work in fp32 and differ only in summation order.
* `hist_topk` / `candidates`: equal (tests/test_torch_soft_warp.py).
* `flow_tiles_fast`: ≤ 1e-3 px, after 40 Horn–Schunck iterations.
* `soft_interp_fast` / `soft_interp_multi` and the API: RGB ≥ 50 dB against
  JAX, and ≤ 1 LSB where both sides picked the same candidates (the warp's
  bound against the golden); the JAX side runs the Pallas kernel in
  interpret mode, so these run at 64×256.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nu_scaler_core as nsc
from nu_scaler_tpu.ops import interpolate as J
from nu_scaler_tpu.ops import resample as jresample
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu.runtime import streaming as jstreaming
from nu_scaler_tpu_torch import core as pc
from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
from nu_scaler_tpu_torch.ops import interpolate as P
from nu_scaler_tpu_torch.ops import resample as presample
from nu_scaler_tpu_torch.runtime import streaming as pstreaming

TOL = 1e-5


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _scene(h: int, w: int, offset: float) -> np.ndarray:
    """A bright blob sliding right over a textured background (the
    tests/test_interpolate.py scene, with rows of texture so that the flow
    has gradients everywhere)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    blob = 230.0 * np.exp(-(((xx - 80.0 - offset) / 16.0) ** 2 + ((yy - h / 2) / (h / 5)) ** 2))
    img = np.zeros((h, w, 4), np.uint8)
    for c in range(3):
        img[..., c] = np.clip(20.0 + blob + 20.0 * np.sin(yy * 0.3 + c), 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def test_constants_equal_jax():
    for name in ("DEFAULT_LAMBDA", "DEFAULT_ALPHA", "DEFAULT_COARSE_ITERS", "DEFAULT_REFINE_ITERS",
                 "DEFAULT_PYRAMID_LEVELS", "WARP_TILE", "WARP_RANGE", "WARP_K", "SOFT_WARP_K"):
        assert getattr(P, name) == getattr(J, name), name


@pytest.mark.parametrize("n", [7, 8, 33, 135, 270])
def test_pyramid_step_operator_equals_jax(n):
    """The JAX step matrix, densified through its own banded apply on the
    identity, equals the port's matrix and the port's step applied to the
    identity."""
    pm = J._pyramid_step_matrix(n)
    dense = np.asarray(J._apply_banded_last(jnp.eye(n, dtype=jnp.float32), pm)).T
    assert dense.shape == (n // 2, n)
    np.testing.assert_array_equal(P.pyramid_step_matrix(n), dense)
    np.testing.assert_array_equal(P.pyramid_step(torch.eye(n), -1).numpy().T, dense)
    np.testing.assert_array_equal(P.pyramid_step(torch.eye(n), -2).numpy(), dense)


@pytest.mark.parametrize("shape", [(17, 23, 34, 46), (135, 240, 270, 480), (40, 52, 21, 30)],
                         ids=["2x-odd", "flow-level", "down"])
def test_resize_f32_matches_jax(rng, shape):
    in_h, in_w, out_h, out_w = shape
    x = rng.standard_normal((in_h, in_w, 2)).astype(np.float32)
    want = np.asarray(jresample.resize_f32(jnp.asarray(x), out_h, out_w))
    got = presample.resize_f32(_t(x), out_h, out_w).numpy()
    assert got.shape == want.shape
    assert _max_abs(got, want) <= TOL


@pytest.mark.parametrize("shape", [(64, 256), (45, 70), (9, 12)], ids=["64x256", "odd", "tiny"])
def test_build_luma_pyramid_matches_jax(rng, shape):
    frame = rng.integers(0, 256, (*shape, 4), np.uint8)
    want = J.build_luma_pyramid(jnp.asarray(frame), 4)
    got = P.build_luma_pyramid(_t(frame), 4)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert _max_abs(g.numpy(), w) <= TOL


@pytest.mark.parametrize("iters", [8, 32])
def test_horn_schunck_matches_jax(rng, iters):
    h, w = 34, 60
    lum1 = rng.random((h, w)).astype(np.float32)
    lum2 = np.clip(lum1 + 0.05 * rng.standard_normal((h, w)), 0, 1).astype(np.float32)
    flow0 = (0.5 * rng.standard_normal((h, w, 2))).astype(np.float32)
    want = J.horn_schunck(jnp.asarray(lum1), jnp.asarray(lum2), jnp.asarray(flow0), iters)
    got = P.horn_schunck(_t(lum1), _t(lum2), _t(flow0), iters)
    assert tuple(got.shape) == (h, w, 2)
    assert _max_abs(got.numpy(), want) <= TOL


def test_horn_schunck_zero_flow_fixpoint(rng):
    """Identical frames: zero flow stays zero (tests/test_interpolate.py)."""
    lum = rng.random((16, 24)).astype(np.float32)
    out = P.horn_schunck(_t(lum), _t(lum), torch.zeros(16, 24, 2), 32)
    assert float(out.abs().max()) == 0.0


def test_flow_upsample_matches_jax(rng):
    flow = rng.standard_normal((135, 240, 2)).astype(np.float32)
    want = J.flow_upsample(jnp.asarray(flow), 270, 480)
    got = P.flow_upsample(_t(flow), 270, 480)
    assert _max_abs(got.numpy(), want) <= TOL


@pytest.mark.parametrize(
    "shape, tile",
    [((16, 128), (8, 128)), ((36, 256), (8, 128)), ((270, 480), (8, 128)), ((24, 96), (8, 32))],
    ids=["one-tile-row", "ragged-36x256", "ragged-270x480", "tile8x32"],
)
def test_block_warp_planar_matches_jax(rng, shape, tile):
    """Including the ragged refinement level of 1080p (270 rows, tile 8;
    480 columns, tile 128): whole tiles are averaged, the ragged edge reuses
    the last tile row / column."""
    h, w = shape
    img = rng.random((1, h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    off = np.stack([3.0 * np.sin(yy / 9.0) + xx / w, 2.0 * np.cos(xx / 40.0)], axis=-1)
    off = (off + 0.2 * rng.standard_normal((h, w, 2))).astype(np.float32)
    want = J.block_warp_planar(jnp.asarray(img), jnp.asarray(off), tile=tile)
    got = P.block_warp_planar(_t(img), _t(off), tile=tile)
    assert tuple(got.shape) == (1, h, w)
    assert _max_abs(got.numpy(), want) <= TOL


def test_block_warp_uniform_integer_shift(rng):
    """An integer shift moves the image exactly (tests/test_interpolate.py)."""
    img = rng.random((3, 16, 128)).astype(np.float32)
    off = np.zeros((16, 128, 2), np.float32)
    off[..., 0] = 2.0
    got = P.block_warp_planar(_t(img), _t(off)).numpy()
    np.testing.assert_allclose(got[:, :, :-2], img[:, :, 2:], atol=1e-6)


def test_tile_helpers_on_ragged_fields(rng):
    field = rng.standard_normal((36, 270, 2)).astype(np.float32)
    tiles = P._tile_mean(_t(field), 8, 128)
    assert tuple(tiles.shape) == (4, 2, 2)
    assert _max_abs(tiles.numpy(), J._tile_mean(jnp.asarray(field), 8, 128)) <= TOL
    assign = rng.integers(0, 8, (4, 2))
    np.testing.assert_array_equal(
        P._tile_to_pixels(_t(assign), 8, 128, 36, 270).numpy(),
        np.asarray(J._tile_to_pixels(jnp.asarray(assign), 8, 128, 36, 270)),
    )


@pytest.mark.parametrize("h, w, base", [(64, 256, 1), (720, 256, 2)], ids=["64x256", "720x256"])
def test_flow_tiles_fast_matches_jax(h, w, base):
    """Half-resolution flow below 720 rows, quarter-resolution (the
    production rule) from 720 rows."""
    assert P.flow_base_level(h, P.WARP_TILE) == base
    a, b = _scene(h, w, 0.0), _scene(h, w, 6.0)
    want = np.asarray(J.flow_tiles_fast(a, b))
    got = P.flow_tiles_fast(_t(a), _t(b)).numpy()
    assert got.shape == want.shape == (h // 8, w // 128, 2)
    print(f"{h}x{w}: max |Δ| {_max_abs(got, want):.3g} px, mean x motion {want[..., 0].mean():.3f}")
    assert _max_abs(got, want) <= 1e-3


def test_flow_base_level_rule():
    """Quarter resolution from 720 rows when the tile divides by 4, else half."""
    for height, tile, want in [
        (1080, (8, 128), 2), (720, (16, 64), 2), (719, (8, 128), 1), (1080, (8, 130), 1),
        (1080, (8, 32), 2), (1080, (6, 128), 1), (64, (8, 128), 1),
    ]:
        assert P.flow_base_level(height, tile) == want


def _same_candidates(a, b, tiles_port, tiles_jax, t) -> bool:
    """Both sides pick the same candidates and assignments for frame A and B."""
    from nu_scaler_tpu.kernels.soft_warp_pallas import _candidates

    tf = np.float32(t)
    for sign in (-tf, np.float32(1) - tf):
        port = swc.candidates(torch.clamp(_t(tiles_port) * float(sign), -48, 48), P.SOFT_WARP_K, 48)
        jax_ = _candidates(jnp.clip(sign * jnp.asarray(tiles_jax), -48, 48), P.SOFT_WARP_K, 48)
        if not all(np.array_equal(p.numpy(), np.asarray(j)) for p, j in zip(port, jax_)):
            return False
    return True


def _check_mid(got, want, same: bool, what: str) -> None:
    p = psnr(got[..., :3], want[..., :3])
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{what}: {p:.2f} dB RGB, max {d.max()} LSB, exact {(d == 0).mean():.6f}, "
          f"same candidates: {same}")
    assert p >= 50.0
    if same:
        assert d.max() <= 1


def test_soft_interp_fast_and_multi_match_jax():
    h, w = 64, 256
    a, b = _scene(h, w, 0.0), _scene(h, w, 9.0)
    tiles_jax = np.asarray(J.flow_tiles_fast(a, b))
    tiles_port = P.flow_tiles_fast(_t(a), _t(b)).numpy()
    single = P.soft_interp_fast(_t(a), _t(b), 0.5).numpy()
    _check_mid(single, np.asarray(J.soft_interp_fast(a, b, 0.5)),
               _same_candidates(a, b, tiles_port, tiles_jax, 0.5), "soft_interp_fast t=0.5")
    ts = (1.0 / 3.0, 2.0 / 3.0)
    multi = P.soft_interp_multi(_t(a), _t(b), ts).numpy()
    assert multi.shape == (2, h, w, 4)
    jmulti = np.asarray(J.soft_interp_multi(a, b, ts))
    for i, t in enumerate(ts):
        _check_mid(multi[i], jmulti[i], _same_candidates(a, b, tiles_port, tiles_jax, t),
                   f"soft_interp_multi t={t:.4f}")
    # one motion solve shared by the times: each mid is the single-t step
    np.testing.assert_array_equal(multi[0], P.soft_interp_fast(_t(a), _t(b), ts[0]).numpy())


def test_soft_interp_flow_beats_blend():
    """The analytic value test of tests/test_interpolate.py on the port:
    motion compensation beats the cross-fade against the true middle frame."""
    a, truth, b = _scene(64, 256, 0.0), _scene(64, 256, 5.0), _scene(64, 256, 10.0)
    mid = P.soft_interp_fast(_t(a), _t(b), 0.5).numpy()
    blend = P.blend_only(_t(a), _t(b), 0.5).numpy()
    assert psnr(mid, truth) > psnr(blend, truth) + 3.0


def _bench_pair(h: int, w: int):
    """bench.py's pair at a small size: the gradient pattern with a white box,
    and the same rolled 16 columns."""
    y, x = np.mgrid[0:h, 0:w].astype(np.uint64)
    a = np.empty((h, w, 4), np.uint8)
    a[..., 0] = x * 255 // w
    a[..., 1] = y * 255 // h
    a[..., 2] = (x + y) * 255 // (w + h)
    a[..., 3] = 255
    a[h // 3: h // 2, w // 3: w // 2, :3] = 255
    return a, np.roll(a, 16, axis=1)


def _wave_pair(h: int, w: int):
    """A smooth texture moved 8 columns: motion the flow recovers."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)

    def wave(shift):
        img = np.full((h, w, 4), 255, np.uint8)
        for c in range(3):
            img[..., c] = np.clip(127.5 + 60.0 * np.sin(2 * np.pi * (x - shift) / 60.0 + c)
                                  + 40.0 * np.sin(2 * np.pi * y / 44.0 + 2 * c), 0, 255)
        return img

    return wave(0.0), wave(8.0)


RAGGED = [((72, 200), (8, 128)), ((48, 112), (16, 64))]


@pytest.mark.parametrize("shape, tile", RAGGED, ids=["72x200-tile8x128", "48x112-tile16x64"])
@pytest.mark.parametrize("pair", [_bench_pair, _wave_pair], ids=["bench-roll", "moving-texture"])
def test_ragged_soft_interp_matches_jax(shape, tile, pair):
    """A frame the warp tile does not divide: full-resolution flow, then the
    overlapped soft warp with bf16 slabs and accumulators, against JAX's
    ragged branch (XLA, eager). Bound: RGB within 1 LSB (measured: equal);
    alpha is cross-faded on both sides. The warp alone, fed JAX's own flow,
    is equal."""
    h, w = shape
    a, b = pair(h, w)
    assert not P.soft_tiles_fit(h, w, tile)
    got = P.soft_interp_fast(_t(a), _t(b), 0.5, tile=tile).numpy()
    want = np.asarray(J.soft_interp_fast(a, b, 0.5, tile=tile))
    ts = (1.0 / 3.0, 2.0 / 3.0)
    got_m = P.soft_interp_multi(_t(a), _t(b), ts, tile=tile).numpy()
    want_m = np.asarray(J.soft_interp_multi(a, b, ts, tile=tile))
    assert got.shape == want.shape == (h, w, 4) and got_m.shape == want_m.shape == (2, h, w, 4)
    for g, wnt, what in ((got, want, "t=0.5"), (got_m, want_m, "ts=(1/3, 2/3)")):
        d = np.abs(g.astype(np.int32) - wnt.astype(np.int32))
        print(f"{h}x{w} {tile} {pair.__name__} {what}: RGB max {d[..., :3].max()} LSB, "
              f"exact {(d == 0).mean():.6f}")
        assert d[..., :3].max() <= 1
        np.testing.assert_array_equal(g[..., 3], wnt[..., 3])
    flow = np.asarray(J.compute_flow_fast(a, b))
    np.testing.assert_array_equal(
        P.warp_blend_soft(_t(a), _t(b), _t(flow), 0.5, tile).numpy(),
        np.asarray(J.warp_blend_fast(a, b, flow, np.float32(0.5), tile=tile, overlap=True)),
    )


def test_ragged_full_resolution_flow_matches_jax():
    """The ragged branch's flow: every refinement level down to level 0."""
    a, b = _wave_pair(72, 200)
    got = P.compute_flow_fast(_t(a), _t(b), base_level=0).numpy()
    want = np.asarray(J.compute_flow_fast(a, b))
    assert got.shape == want.shape == (72, 200, 2)
    assert _max_abs(got, want) <= 1e-4


def test_flow_soft_takes_rgba_only():
    a = torch.zeros((16, 128, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"RGBA frames \[H, W, 4\]"):
        P.soft_interp_fast(a, a, 0.5)
    with pytest.raises(ValueError, match=r"RGBA frames \[H, W, 4\]"):
        P.soft_interp_multi(a, a, (0.5,))


def test_factories_dispatch_each_mode(monkeypatch):
    """A mode past `check_mode` that the factories do not serve raises; no
    mode is served as another: "flow_soft_ref" (ROADMAP queue 1, item 10)
    is the flow_soft mid refined, not the flow_soft mid."""
    monkeypatch.setattr(P, "check_mode", lambda mode: None)
    with pytest.raises(ValueError, match="unknown interpolation mode: 'bogus'"):
        P.make_interpolator(16, 128, "bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown multi-interpolation mode: 'bogus'"):
        P.make_multi_interpolator(16, 128, (0.5,), "bogus", device="cpu")
    a, b = _t(_scene(16, 128, 0.0)), _t(_scene(16, 128, 4.0))
    for t in (0.5,):
        soft = P.make_interpolator(16, 128, "flow_soft", device="cpu")(a, b, t)
        ref = P.make_interpolator(16, 128, "flow_soft_ref", device="cpu")(a, b, t)
        multi = P.make_multi_interpolator(16, 128, (t,), "flow_soft_ref", device="cpu")(a, b)
        assert not torch.equal(ref, soft) and torch.equal(multi[0], ref)


# ---------------------------------------------------------------------------
# the slice through the API and the live pipeline
# ---------------------------------------------------------------------------


def _api_case():
    h, w = 64, 256
    a, b = _scene(h, w, 0.0), _scene(h, w, 9.0)
    same = _same_candidates(a, b, P.flow_tiles_fast(_t(a), _t(b)).numpy(),
                            np.asarray(J.flow_tiles_fast(a, b)), 0.5)
    port = pc.WgpuFrameInterpolator(mode="flow_soft", device="cpu")
    ref = nsc.WgpuFrameInterpolator(mode="flow_soft")
    assert port.warp_tile == ref.warp_tile == (8, 128)
    return h, w, a, b, same, port, ref


def test_interpolate_py_flow_soft_matches_core():
    h, w, a, b, same, port, ref = _api_case()
    got = port.interpolate_py(a.tobytes(), b.tobytes(), w, h, time_t=0.5)
    want = ref.interpolate_py(a.tobytes(), b.tobytes(), w, h, time_t=0.5)
    assert isinstance(got, bytes) and len(got) == h * w * 4
    _check_mid(np.frombuffer(got, np.uint8).reshape(h, w, 4),
               np.frombuffer(want, np.uint8).reshape(h, w, 4), same, "interpolate_py flow_soft")


def test_interpolate_multi_py_flow_soft_matches_core():
    h, w, a, b, same, port, ref = _api_case()
    ts = (1.0 / 3.0, 2.0 / 3.0)
    got_m = port.interpolate_multi_py(a.tobytes(), b.tobytes(), w, h)
    want_m = ref.interpolate_multi_py(a.tobytes(), b.tobytes(), w, h)
    assert len(got_m) == len(want_m) == 2
    for g, wb, t in zip(got_m, want_m, ts):
        _check_mid(np.frombuffer(g, np.uint8).reshape(h, w, 4),
                   np.frombuffer(wb, np.uint8).reshape(h, w, 4), same,
                   f"interpolate_multi_py t={t:.4f}")


@pytest.mark.parametrize("preset, shape", [(None, (72, 200)), ("16x16", (48, 112))],
                         ids=["wide32x8-72x200", "16x16-48x112"])
def test_api_serves_ragged_frames(preset, shape):
    """`interpolate_py` and `interpolate_multi_py` in flow_soft on frames the
    preset's warp tile does not divide: the bytes of the ragged branch, and
    against nu_scaler_core (which runs it under jit) RGB ≥ 50 dB."""
    h, w = shape
    a, b = _wave_pair(h, w)
    port = pc.WgpuFrameInterpolator(preset, mode="flow_soft", device="cpu")
    assert not P.soft_tiles_fit(h, w, port.warp_tile)
    mid = port.interpolate_py(a.tobytes(), b.tobytes(), w, h, time_t=0.5)
    assert mid == P.soft_interp_fast(_t(a), _t(b), 0.5, tile=port.warp_tile).numpy().tobytes()
    mids = port.interpolate_multi_py(a.tobytes(), b.tobytes(), w, h)
    want = P.soft_interp_multi(_t(a), _t(b), (1.0 / 3.0, 2.0 / 3.0), tile=port.warp_tile).numpy()
    assert mids == [m.tobytes() for m in want]
    ref = nsc.WgpuFrameInterpolator(preset, mode="flow_soft")
    jmid = ref.interpolate_py(a.tobytes(), b.tobytes(), w, h, time_t=0.5)
    got, jgot = (np.frombuffer(x, np.uint8).reshape(h, w, 4) for x in (mid, jmid))
    print(f"{h}x{w} {port.warp_tile}: vs nu_scaler_core {psnr(got[..., :3], jgot[..., :3]):.2f} dB RGB")
    assert psnr(got[..., :3], jgot[..., :3]) >= 50.0


def test_interpolate_multi_py_maps_modes_as_core():
    """A mode without a multi-time form (flow_exact) serves flow_soft, as
    nu_scaler_core/interpolator.py maps it."""
    h, w = 16, 128
    a, b = _wave_pair(h, w)
    interp = pc.WgpuFrameInterpolator(mode="flow_soft", device="cpu")
    want = interp.interpolate_multi_py(a.tobytes(), b.tobytes(), w, h)
    interp.mode = "flow_exact"
    assert interp.interpolate_multi_py(a.tobytes(), b.tobytes(), w, h) == want


def test_interpolate_multi_py_blend_and_checks(rng):
    """Mode blend: one cross-fade per time, equal to `interpolate_py` at
    each t; against nu_scaler_core (which runs blend_only under jit) equal
    except ±1 on exact-half ties. The argument checks of
    nu_scaler_core/interpolator.py:111-150."""
    h, w = 16, 32
    a = rng.integers(0, 256, (h, w, 4), np.uint8)
    b = rng.integers(0, 256, (h, w, 4), np.uint8)
    port = pc.WgpuFrameInterpolator(device="cpu")
    ts = (0.25, 0.5, 0.75)
    outs = port.interpolate_multi_py(a.tobytes(), b.tobytes(), w, h, times=ts)
    want = nsc.WgpuFrameInterpolator().interpolate_multi_py(a.tobytes(), b.tobytes(), w, h, times=ts)
    for o, wb, t in zip(outs, want, ts):
        assert o == port.interpolate_py(a.tobytes(), b.tobytes(), w, h, time_t=t)
        d = np.frombuffer(o, np.uint8).astype(int) - np.frombuffer(wb, np.uint8).astype(int)
        mix = a.astype(np.float64) + (b.astype(np.float64) - a) * np.float32(t)
        tie = np.abs(mix - np.floor(mix) - 0.5).ravel() < 1e-4
        assert np.abs(d).max() <= 1 and np.all((d == 0) | tie)
    for times in ((), (1.5,), (-0.1, 0.5)):
        with pytest.raises(ValueError, match="times must be non-empty"):
            port.interpolate_multi_py(a.tobytes(), b.tobytes(), w, h, times=times)
    with pytest.raises(ValueError, match="Expected 2048 bytes per frame"):
        port.interpolate_multi_py(a.tobytes()[:-4], b.tobytes(), w, h)


def test_create_interpolator():
    assert P.MODES == ("blend", "flow", "flow_soft", "flow_soft_ref", "flow_exact")
    for kind, want in (("blend", "blend"), ("flow_soft", "flow_soft"), ("bogus", "blend")):
        got = pc.create_interpolator(kind, "tall", device="cpu")
        assert got.mode == want == nsc.create_interpolator(kind, "tall").mode
        assert got.warp_tile == nsc.create_interpolator(kind, "tall").warp_tile == (32, 32)
    for kind in ("flow", "flow_exact"):
        got = pc.create_interpolator(kind, "tall", device="cpu")
        assert got.mode == kind == nsc.create_interpolator(kind, "tall").mode
        assert got.warp_tile == (32, 32)
    got = pc.create_interpolator("flow_soft_ref", "tall", device="cpu")
    assert got.mode == "flow_soft_ref" == nsc.create_interpolator("flow_soft_ref", "tall").mode
    assert got.warp_tile == (32, 32)


def test_live_pipeline_flow_soft():
    """The non-fused LivePipeline branch with a flow_soft interp_fn: the JAX
    output counts (1 for the first frame, then mid + current per frame), and
    every mid is the port's soft_interp_fast of its pair, upscaled. Against
    the JAX pipeline driven the same way: RGB ≥ 50 dB per frame."""
    h, w = 64, 256
    frames = [_scene(h, w, 4.0 * i) for i in range(3)]
    up = presample.make_resampler(h, w, 2 * h, 2 * w, "lanczos3", device="cpu")
    interp = P.make_interpolator(h, w, "flow_soft", device="cpu")
    pipe = pstreaming.LivePipeline(up, interp, device="cpu", depth=1)
    jpipe = jstreaming.LivePipeline(
        jresample.make_resampler(h, w, 2 * h, 2 * w, "lanczos3"),
        J.make_interpolator(h, w, "flow_soft"), depth=1,
    )
    counts, jcounts, outs, jouts = [], [], [], []
    for f in frames:
        got, want = pipe.put(f), jpipe.put(f)
        counts.append(len(got))
        jcounts.append(len(want))
        outs += got
        jouts += want
    outs += pipe.drain()
    jouts += [np.asarray(o) for o in jpipe.drain()]
    assert len(outs) == len(jouts) == 1 + 2 * (len(frames) - 1)
    assert counts == jcounts
    for i in (1, 3):
        pair = frames[(i - 1) // 2], frames[(i + 1) // 2]
        mid = P.soft_interp_fast(_t(pair[0]), _t(pair[1]), 0.5)
        np.testing.assert_array_equal(outs[i], up(mid).numpy())
    for o, jo in zip(outs, jouts):
        assert psnr(o, np.asarray(jo)) >= 50.0
