"""The port's mesh functions (`nu_scaler_tpu_torch/parallel/mesh.py`) on an
8-shard CPU mesh, ``Mesh((cpu,) * 8)``, the port's counterpart of the 8
virtual devices of tests/conftest.py. The cases follow tests/test_parallel.py.

* Port against port: each function equals the port's single-device path
  byte for byte (ragged batches padded and sliced back, sp at levels 2 and
  4, the halos at every shard boundary), and refuses what JAX refuses.
* Port against JAX: each function against JAX's own sharded function on the
  conftest's 8 virtual devices, on the same inputs, within the bounds the
  single-device paths hold: resample ≤ 2 LSB; FSR ≤ 1 LSB but at FsrCubic
  cut-off ties (≤ 8 LSB on ≤ 1% of the pixels); blend ±1 (exact-half ties);
  flow_soft ≤ 2 LSB where both sides take the ragged soft warp (JAX's sp
  test's bound) and RGB ≥ 50 dB where the port's soft warp kernel stands
  against JAX's XLA soft twin (tests/test_torch_soft_warp.py's bound);
  `esrgan_infer_spatial` fp32 within 2e-5 (JAX's own sp bound) and its
  int8 twin within 1e-4 (quantisation flips at rounding ties); the learned
  batch as one card's int8 graph against JAX's jitted one (≥ 45 dB RGB, mean
  |d| < 1 LSB, alpha within 1: tests/test_torch_int8.py's bound); sp
  "flow_soft_ref", whose refinement JAX runs as the float-domain module in
  bf16 and the port as its serving graph, ≥ 40 dB.
* The API: `upscale_batch`, classical and learned, goes through the mesh
  when `default_mesh` holds more than one shard, with the bytes of one card.

JAX's outputs are computed once a module (fixtures), at test_parallel.py's
shapes, so its compiled programs are shared with that file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.parallel import mesh as jmesh
from nu_scaler_tpu_torch.core import upscaler as pup
from nu_scaler_tpu_torch.models import esrgan_lite as el
from nu_scaler_tpu_torch.models import interp_refine as pir
from nu_scaler_tpu_torch.ops import fsr as pfsr
from nu_scaler_tpu_torch.ops import resample as presample
from nu_scaler_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")
MESH = pmesh.Mesh((CPU,) * 8)


def _rng(seed: int = 1234) -> np.random.Generator:
    return np.random.default_rng(seed)


def _eq(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _lsb(a, b) -> np.ndarray:
    return np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))


def _psnr_rgb(a, b) -> float:
    d = (np.asarray(a)[..., :3].astype(np.float64) - np.asarray(b)[..., :3]) ** 2
    mse = d.mean()
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def _pair(h: int, w: int, seed: int = 1234):
    a = _rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    return a, np.roll(a, 3, axis=1)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_construction():
    """Explicit meshes compare and hash by devices and axis; make_mesh and
    default_mesh on the CPU give one shard and refuse more."""
    assert len(MESH) == 8 and MESH == pmesh.Mesh([CPU] * 8) and hash(MESH) == hash(pmesh.Mesh([CPU] * 8))
    assert MESH != pmesh.Mesh((CPU,) * 8, axis="rows")
    assert pmesh.make_mesh(device="cpu") == pmesh.Mesh((CPU,))
    assert pmesh.make_mesh(1, device="cpu") == pmesh.default_mesh("cpu") == pmesh.Mesh((CPU,))
    with pytest.raises(ValueError, match="device"):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        pmesh.Mesh(())
    assert "cpu" in repr(MESH)


@pytest.mark.parametrize("n, size, multiple", [(64, 8, 1), (1080, 4, 1), (1080, 4, 8), (20, 8, 1), (48, 8, 4)])
def test_bands_cover_the_rows(n, size, multiple):
    bands = pmesh._bands(n, size, multiple)
    assert len(bands) == size and sum(r for _, r in bands) == n
    assert all(r0 % multiple == 0 for r0, r in bands if r)
    assert [r0 + r for r0, r in bands[:-1]] == [r0 for r0, _ in bands[1:]]


# ---------------------------------------------------------------------------
# port against port: dp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 5])
def test_upscale_batch_sharded_equals_one_device(n):
    frames = _rng().integers(0, 256, (n, 24, 32, 4), np.uint8)
    out = pmesh.upscale_batch_sharded(frames, 48, 64, "lanczos3", MESH)
    assert _eq(out, presample.make_resampler(24, 32, 48, 64, "lanczos3", CPU)(frames))


def test_shard_batch_resampler_refuses_indivisible():
    fn = pmesh.shard_batch_resampler(MESH, 16, 16, 32, 32, "bilinear")
    with pytest.raises(ValueError, match="not divisible"):
        fn(np.zeros((5, 16, 16, 4), np.uint8))


@pytest.mark.parametrize("n, out_hw", [(8, (32, 48)), (3, (32, 48)), (5, (24, 36))])
def test_fsr_batch_sharded_equals_one_device(n, out_hw):
    frames = _rng().integers(0, 256, (n, 16, 24, 4), np.uint8)
    out = pmesh.fsr_batch_sharded(frames, *out_hw, "quality", MESH)
    assert _eq(out, pfsr.make_fsr_upscaler(16, 24, *out_hw, "quality", CPU)(frames))


@pytest.mark.parametrize("mode", pmesh.MODES)
def test_interpolate_batch_sharded_equals_one_device(mode):
    """Five pairs (padded to 8) at 32×256, where the soft warp kernel's
    wrapper serves; each mid equals `pair_mid` on one device."""
    pa = _rng().integers(0, 256, (5, 32, 256, 4), np.uint8)
    pb = np.roll(pa, 3, axis=2)
    out = pmesh.interpolate_batch_sharded(pa, pb, 0.5, mode, MESH, levels=2)
    refine = pir.get_refine_graph(32, 256, CPU) if mode == "flow_soft_ref" else None
    assert out.shape == pa.shape
    for i in range(5):
        want = pmesh.pair_mid(torch.from_numpy(pa[i]), torch.from_numpy(pb[i]), 0.5, mode, 2, refine)
        assert _eq(out[i], want), i


def test_interpolate_batch_sharded_refuses():
    pa = np.zeros((2, 30, 64, 4), np.uint8)  # 30 rows: not a multiple of the net's stride
    with pytest.raises(ValueError, match="flow_soft_ref"):
        pmesh.interpolate_batch_sharded(pa, pa, 0.5, "flow_soft_ref", MESH)
    with pytest.raises(ValueError, match="mode"):
        pmesh.interpolate_batch_sharded(pa, pa, 0.5, "flow_exact", MESH)


@pytest.mark.parametrize("prefer", ["quality", "ultra"])
def test_esrgan_batch_sharded_equals_one_device(prefer):
    imgs = _rng().integers(0, 256, (6, 16, 16, 4), np.uint8)  # 6 % 8: the pad path
    out = pmesh.esrgan_batch_sharded(imgs, 32, 32, MESH, prefer)
    assert _eq(out, el.make_pretrained_batch_upscaler(16, 16, 32, 32, prefer, CPU)(imgs))


# ---------------------------------------------------------------------------
# port against port: sp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["bilinear", "lanczos3", "nearest", "area"])
def test_upscale_frame_spatial_equals_one_device(algo):
    frame = _rng().integers(0, 256, (24, 32, 4), np.uint8)
    out = pmesh.upscale_frame_spatial(frame, 48, 64, algo, MESH)
    assert _eq(out, presample.make_resampler(24, 32, 48, 64, algo, CPU)(frame))


def test_spatial_resampler_refuses_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_spatial_resampler(MESH, 24, 32, 50, 64, "lanczos3")


@pytest.mark.parametrize("in_hw, out_hw", [((16, 24), (32, 48)), ((16, 24), (48, 72)), ((16, 24), (64, 96)),
                                           ((16, 24), (16, 24)), ((16, 24), (24, 36)), ((24, 24), (56, 56))])
def test_fsr_frame_spatial_equals_one_device(in_hw, out_hw):
    """Integer scales 1–4 (the kernel's wrapper on each shard's rows and the
    halo) and the general path at 1.5× and 2.33×; output bands of
    ceil(OH / 8) rows."""
    frame = _rng().integers(0, 256, (*in_hw, 4), np.uint8)
    out = pmesh.fsr_frame_spatial(frame, *out_hw, "quality", MESH)
    assert _eq(out, pfsr.make_fsr_upscaler(*in_hw, *out_hw, "quality", CPU)(frame))


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_fsr_halo_at_every_residue(s, monkeypatch):
    """Every band start o0 in 0 .. 3s and length 1 .. 2s + 1 of a 13×9 frame
    at scale s gives the whole frame's rows with `FSR_HALO`; one row less
    of halo does not, somewhere: the halo is the least that works."""
    frame = torch.from_numpy(_rng(s).integers(0, 256, (13, 9, 4), np.uint8))
    fn = pfsr.make_fsr_upscaler(13, 9, 13 * s, 9 * s, "quality", CPU)
    whole = fn(frame)
    cases = [(o0, rows) for o0 in range(3 * s + 1) for rows in range(1, 2 * s + 2)]
    for o0, rows in cases:
        assert _eq(pmesh._fsr_band(frame, fn, "quality", o0, rows), whole[o0 : o0 + rows]), (o0, rows)
    monkeypatch.setattr(pmesh, "FSR_HALO", pmesh.FSR_HALO - 1)
    assert any(not _eq(pmesh._fsr_band(frame, fn, "quality", o0, rows), whole[o0 : o0 + rows])
               for o0, rows in cases)


def test_fsr_frame_spatial_refuses_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.fsr_frame_spatial(np.zeros((20, 24, 4), np.uint8), 40, 48, "quality", MESH)


@pytest.mark.parametrize("shape", [(64, 64), (64, 256)])
@pytest.mark.parametrize("mode", ["blend", "flow", "flow_soft"])
@pytest.mark.parametrize("levels", [2, 4])
def test_interpolate_frame_spatial_equals_one_device(shape, mode, levels):
    """64×64 takes the ragged soft warp, 64×256 the soft warp kernel's
    wrapper on each shard's 8 rows (levels=4 puts the coarsest pyramid level
    at 4 rows in all)."""
    a, b = _pair(*shape)
    out = pmesh.interpolate_frame_spatial(a, b, 0.5, mode, MESH, levels=levels)
    assert _eq(out, pmesh.pair_mid(torch.from_numpy(a), torch.from_numpy(b), 0.5, mode, levels))


@pytest.mark.parametrize("levels", [2, 4])
def test_interpolate_multi_spatial_equals_one_device(levels):
    a, b = _pair(64, 256)
    ts = (1.0 / 3.0, 2.0 / 3.0)
    out = pmesh.interpolate_multi_spatial(a, b, ts, "flow_soft", MESH, levels=levels)
    assert out.shape == (2, 64, 256, 4)
    for i, t in enumerate(ts):
        assert _eq(out[i], pmesh.pair_mid(torch.from_numpy(a), torch.from_numpy(b), t, "flow_soft", levels))


@pytest.mark.parametrize("shards", [2, 4])
def test_interpolate_frame_spatial_refined_equals_one_device(shards, monkeypatch):
    """sp flow_soft_ref: each shard's soft rows and the net's receptive
    field (16 rows) refined by the serving graph; the bytes of the serving
    graph on the whole frame's mid. A halo of one stride differs (shorter
    halos than the field may not show in the u8 bytes: the influence of the
    zero padding fades through the convs)."""
    a, b = _pair(64, 256)
    mesh = pmesh.Mesh((CPU,) * shards)
    want = pmesh.pair_mid(torch.from_numpy(a), torch.from_numpy(b), 0.5, "flow_soft_ref", 2,
                          pir.get_refine_graph(64, 256, CPU))
    assert _eq(pmesh.interpolate_frame_spatial(a, b, 0.5, "flow_soft_ref", mesh, levels=2), want)
    multi = pmesh.interpolate_multi_spatial(a, b, (0.5,), "flow_soft_ref", mesh, levels=2)
    assert _eq(multi[0], want)
    monkeypatch.setattr(pmesh, "receptive_rows", lambda model: model.stride)
    assert not _eq(pmesh.interpolate_frame_spatial(a, b, 0.5, "flow_soft_ref", mesh, levels=2), want)


def test_interpolate_spatial_refuses_indivisible():
    a, _ = _pair(60, 64)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.interpolate_frame_spatial(a, a, 0.5, "blend", MESH)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.interpolate_multi_spatial(a, a, (0.5,), "blend", MESH)
    b, _ = _pair(72, 256)  # 9 rows a shard: not a multiple of the net's stride
    with pytest.raises(ValueError, match="stride"):
        pmesh.interpolate_frame_spatial(b, b, 0.5, "flow_soft_ref", MESH)


def _esrgan_case(seed: int):
    """A seeded stride-2 ESRGANLiteTPU (8 features, 1 block) and x
    [1, 64, 32, 3] in [0, 1]: test_parallel.py's sp case."""
    model = el.init_module(el.ESRGANLiteTPU(upscale=2, stride=2, features=8, blocks=1), seed)
    x = torch.from_numpy(_rng(seed).random((1, 64, 32, 3), dtype=np.float32))
    return model, x


def test_esrgan_infer_spatial_equals_one_device():
    model, x = _esrgan_case(0)
    with torch.no_grad():
        want = model(x)
    assert _eq(pmesh.esrgan_infer_spatial(model, x, MESH), want)
    scales = el.calibrate_trunk_scales(model, x.numpy())
    assert _eq(pmesh.esrgan_infer_spatial(model, x, MESH, quant_scales=scales),
               el.make_quant_apply(model, scales)(x))


def test_esrgan_infer_spatial_refuses_indivisible():
    model, x = _esrgan_case(0)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.esrgan_infer_spatial(model, x[:, :56], MESH)  # 56 rows: 8 shards × stride 2 do not divide


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------


def _frames(n: int, h: int, w: int) -> list[bytes]:
    return [f.tobytes() for f in _rng().integers(0, 256, (n, h, w, 4), np.uint8)]


def _spy(monkeypatch, name: str) -> list:
    calls = []
    real = getattr(pmesh, name)

    def spy(*args, **kwargs):
        calls.append([a for a in (*args, *kwargs.values()) if isinstance(a, pmesh.Mesh)])
        return real(*args, **kwargs)

    monkeypatch.setattr(pmesh, name, spy)
    return calls


@pytest.mark.parametrize("make, sharded", [
    (lambda: pup.PyWgpuUpscaler("quality", "lanczos3", device="cpu"), "upscale_batch_sharded"),
    (lambda: pup.create_advanced_upscaler("quality", device="cpu"), "upscale_batch_sharded"),
    (lambda: pup.create_advanced_upscaler("ultra", device="cpu"), "esrgan_batch_sharded"),
])
def test_api_upscale_batch_goes_through_the_mesh(make, sharded, monkeypatch):
    """With `default_mesh` patched to the 8-shard CPU mesh, upscale_batch
    (classical, and the learned tier) calls the sharded function and gives
    the bytes of the one-device API; the FSR tier stays on one device."""
    frames = _frames(5, 16, 16)
    up = make()
    up.initialize(16, 16, 32, 32)
    if isinstance(up, pup.PyAdvancedWgpuUpscaler):
        up.adaptive_quality = False
    want = up.upscale_batch(frames)
    calls = _spy(monkeypatch, sharded)
    monkeypatch.setattr(pmesh, "default_mesh", lambda device=None: MESH)
    assert up.upscale_batch(frames) == want
    assert calls == [[MESH]]
    fsr = pup.create_fsr_upscaler("quality", device="cpu")
    fsr.initialize(16, 16, 32, 32)
    fsr_calls = _spy(monkeypatch, "fsr_batch_sharded")
    assert fsr.upscale_batch(frames) == [fsr.upscale(f) for f in frames] and fsr_calls == []


# ---------------------------------------------------------------------------
# port against JAX (8 virtual devices)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"
    return jmesh.make_mesh()


@pytest.fixture(scope="module")
def jax_resample(jax_mesh):
    rng = np.random.default_rng(1234)
    frames = rng.integers(0, 256, (8, 24, 32, 4), np.uint8)
    frame = rng.integers(0, 256, (24, 32, 4), np.uint8)
    return frames, frame, {
        "batch": np.asarray(jmesh.upscale_batch_sharded(frames, 48, 64, "lanczos3", jax_mesh)),
        **{algo: np.asarray(jmesh.upscale_frame_spatial(frame, 48, 64, algo, jax_mesh))
           for algo in ("bilinear", "lanczos3")},
    }


def test_resample_against_jax(jax_resample):
    frames, frame, want = jax_resample
    got = pmesh.upscale_batch_sharded(frames, 48, 64, "lanczos3", MESH).numpy()
    assert _lsb(got, want["batch"]).max() <= 2
    for algo in ("bilinear", "lanczos3"):
        d = _lsb(pmesh.upscale_frame_spatial(frame, 48, 64, algo, MESH).numpy(), want[algo])
        print(f"sp {algo}: max {d.max()} LSB")
        assert d.max() <= 2


@pytest.fixture(scope="module")
def jax_fsr(jax_mesh):
    rng = np.random.default_rng(1234)
    frames = rng.integers(0, 256, (8, 16, 24, 4), np.uint8)
    frame = rng.integers(0, 256, (16, 24, 4), np.uint8)
    return frames, frame, (np.asarray(jmesh.fsr_batch_sharded(frames, 32, 48, "quality", jax_mesh)),
                           np.asarray(jmesh.fsr_frame_spatial(frame, 32, 48, "quality", jax_mesh)))


def _fsr_bound(got, want, what: str) -> None:
    d = _lsb(got, want)
    print(f"{what}: max {d.max()} LSB, {(d > 1).mean():.5f} of the values past 1")
    assert d.max() <= 8 and (d > 1).mean() <= 0.01


def test_fsr_against_jax(jax_fsr):
    frames, frame, (batch, spatial) = jax_fsr
    _fsr_bound(pmesh.fsr_batch_sharded(frames, 32, 48, "quality", MESH).numpy(), batch, "dp fsr")
    _fsr_bound(pmesh.fsr_frame_spatial(frame, 32, 48, "quality", MESH).numpy(), spatial, "sp fsr")


@pytest.fixture(scope="module")
def jax_interp(jax_mesh):
    """JAX's dp mids (blend, flow_soft; 8 pairs at 32×64) and sp mids (64×64
    at levels 2 and 4, 64×256 flow_soft at levels 4; multi at (1/3, 2/3))."""
    rng = np.random.default_rng(1234)
    pa = rng.integers(0, 256, (8, 32, 64, 4), np.uint8)
    pb = np.roll(pa, 3, axis=2)
    a, b = _pair(64, 64)
    wa, wb = _pair(64, 256)
    out = {("dp", mode): np.asarray(jmesh.interpolate_batch_sharded(pa, pb, 0.5, mode, jax_mesh, levels=2))
           for mode in ("blend", "flow_soft")}
    for mode in ("blend", "flow", "flow_soft"):
        for levels in (2, 4):
            out[("sp", mode, levels)] = np.asarray(
                jmesh.interpolate_frame_spatial(a, b, 0.5, mode, jax_mesh, levels=levels))
    out["wide"] = np.asarray(jmesh.interpolate_frame_spatial(wa, wb, 0.5, "flow_soft", jax_mesh, levels=4))
    out["multi"] = np.asarray(jmesh.interpolate_multi_spatial(a, b, (1 / 3, 2 / 3), "flow_soft", jax_mesh,
                                                              levels=4))
    return pa, pb, (a, b), (wa, wb), out


def test_interpolate_against_jax(jax_interp):
    pa, pb, (a, b), (wa, wb), want = jax_interp
    for mode in ("blend", "flow_soft"):
        d = _lsb(pmesh.interpolate_batch_sharded(pa, pb, 0.5, mode, MESH, levels=2).numpy(), want[("dp", mode)])
        print(f"dp {mode}: max {d.max()} LSB")
        assert d.max() <= (1 if mode == "blend" else 2)
    for mode in ("blend", "flow", "flow_soft"):
        for levels in (2, 4):
            got = pmesh.interpolate_frame_spatial(a, b, 0.5, mode, MESH, levels=levels).numpy()
            d = _lsb(got, want[("sp", mode, levels)])
            print(f"sp {mode} levels={levels}: max {d.max()} LSB")
            assert d.max() <= (1 if mode == "blend" else 2)
    multi = pmesh.interpolate_multi_spatial(a, b, (1 / 3, 2 / 3), "flow_soft", MESH, levels=4).numpy()
    assert _lsb(multi, want["multi"]).max() <= 2
    wide = pmesh.interpolate_frame_spatial(wa, wb, 0.5, "flow_soft", MESH, levels=4).numpy()
    p = _psnr_rgb(wide, want["wide"])
    print(f"sp flow_soft 64x256 (the port's kernel vs JAX's XLA soft twin): {p:.2f} dB RGB")
    assert p >= 50.0


def test_interpolate_refined_against_jax(jax_mesh):
    """sp flow_soft_ref: the port's serving graph on each shard's band
    against JAX's float-domain module forward (bf16) on its row shards,
    with the committed interp_ref4 weights on both sides."""
    from nu_scaler_tpu.models import interp_refine as jir

    if not jir.refine_available():
        pytest.skip("no interp_ref4 checkpoint for the JAX side")
    a, b = _pair(64, 256)
    want = np.asarray(jmesh.interpolate_frame_spatial(a, b, 0.5, "flow_soft_ref", jax_mesh, levels=2))
    got = pmesh.interpolate_frame_spatial(a, b, 0.5, "flow_soft_ref", pmesh.Mesh((CPU,) * 8), levels=2)
    p = _psnr_rgb(got.numpy(), want)
    print(f"sp flow_soft_ref: {p:.2f} dB RGB, max {_lsb(got.numpy(), want).max()} LSB")
    assert p >= 40.0


def test_esrgan_infer_spatial_against_jax(jax_mesh):
    """test_parallel.py's sp cases: the JAX module's params carried across;
    fp32 within 2e-5, the int8 twin (JAX's calibration on both sides)
    within 1e-4."""
    from nu_scaler_tpu.models import esrgan_lite as jel

    jm = jel.ESRGANLiteTPU(upscale=2, stride=2, features=8, blocks=1)
    x = np.random.default_rng(0).random((1, 64, 32, 3), dtype=np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pm = el.ESRGANLiteTPU(upscale=2, stride=2, features=8, blocks=1)
    pm.load_state_dict(el.params_from_flax(jax.device_get(params)))
    want = np.asarray(jmesh.esrgan_infer_spatial(jm, params, jnp.asarray(x), jax_mesh))
    got = pmesh.esrgan_infer_spatial(pm, torch.from_numpy(x), MESH).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    scales = jel.calibrate_trunk_scales(jm, params, x)
    want = np.asarray(jmesh.esrgan_infer_spatial(jm, params, jnp.asarray(x), jax_mesh, quant_scales=scales))
    got = pmesh.esrgan_infer_spatial(pm, torch.from_numpy(x), MESH, quant_scales=scales).numpy()
    print(f"sp int8: max {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_esrgan_batch_against_jax(jax_mesh):
    imgs = _rng().integers(0, 256, (6, 16, 16, 4), np.uint8)
    want = np.asarray(jmesh.esrgan_batch_sharded(imgs, 32, 32, jax_mesh))
    got = pmesh.esrgan_batch_sharded(imgs, 32, 32, MESH).numpy()
    d = _lsb(got, want)
    p = _psnr_rgb(got, want)
    print(f"dp learned: {p:.2f} dB RGB, mean {d[..., :3].mean():.4f} LSB, max {d.max()} LSB")
    assert p >= 45.0 and d[..., :3].mean() < 1.0 and d[..., 3].max() <= 1
