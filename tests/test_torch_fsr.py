"""The port's FSR tier (nu_scaler_tpu_torch.ops.fsr, kernels/fsr_cuda.py,
PyFsrUpscaler) against the JAX package's, on the CPU, where every wrapper runs
its plain PyTorch version.

The same seeded numpy frames go to both packages. Bounds:

* the plain version of the fused kernel against the JAX Pallas pipeline
  (interpret mode, `impl="pallas"`): ≤ 1 LSB at every output pixel outside
  the reach of a FsrCubic cut-off tie, and such pixels under 2% of the
  output. FsrCubic jumps from weight 1 to 0 at distance 2. Where a tap's fp32
  distance lies within 1e-6 of 2, the last bit decides the side: XLA's CPU
  compile of the JAX function contracts multiply-adds into FMAs
  (`test_xla_cpu_contracts_multiply_adds`), the port and its kernel round
  every operation on its own, and RCAS spreads the changed EASU value to the
  neighbouring output pixels. Measured: 0–1 LSB outside, up to 8 LSB inside.
* against the JAX XLA polyphase path: PSNR ≥ 55 dB (the bound JAX's own test
  holds its two paths to, tests/test_fsr.py).
* against the `easu_ref → rcas_ref` golden: PSNR ≥ 40 dB and ≤ 12 LSB (the
  contract of bench.py's psnr_fsr_db gate).
* the general path (non-integer or unequal axis scales): ≤ 1 LSB against
  JAX `make_fsr_upscaler`; `easu` and `rcas` alone equal to JAX's eager
  functions.
"""

import jax
import numpy as np
import pytest
import torch

import nu_scaler_core as nsc
from nu_scaler_tpu.kernels import reference as jref
from nu_scaler_tpu.ops import fsr as JF
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch import core as pc
from nu_scaler_tpu_torch.kernels import fsr_cuda as F
from nu_scaler_tpu_torch.kernels import reference as pref
from nu_scaler_tpu_torch.ops import fsr as PF

TIE_EPS = 1e-6  # |distance − 2| below which the rounding picks FsrCubic's side
TIE_SHARE_MAX = 0.02


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _frame(rng, h, w):
    return rng.integers(0, 256, (h, w, 4), np.uint8)


def _cutoff_ties(img: np.ndarray, s: int) -> np.ndarray:
    """Output pixels [sH, sW] within RCAS's reach (one pixel) of an input
    pixel with a tap distance within TIE_EPS of FsrCubic's cut-off at 2."""
    rgb = _t(img)[None, ..., :3].permute(0, 3, 1, 2).float() * F.INV_255
    wx, wy = (v[0].double().numpy() for v in F._direction(rgb))
    tie = np.zeros(wx.shape, bool)
    for py in range(s):
        for px in range(s):
            offs = (px + 0.5) / s * wx + (py + 0.5) / s * wy
            for ty in range(4):
                for tx in range(4):
                    tie |= np.abs(np.abs(tx * wx + ty * wy - offs) - 2.0) < TIE_EPS
    m = np.repeat(np.repeat(tie, s, 0), s, 1)
    out = m.copy()
    out[1:] |= m[:-1]
    out[:-1] |= m[1:]
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    return out


def test_constants_and_goldens_equal_jax(rng):
    assert pref.FSR_SHARPNESS == jref.FSR_SHARPNESS == JF.FSR_SHARPNESS
    img = _frame(rng, 19, 27)
    for out_hw, sharp in (((38, 54), 0.17), ((57, 81), 0.25), ((25, 40), 0.0)):
        e = pref.easu_ref(img, *out_hw, sharp)
        np.testing.assert_array_equal(e, jref.easu_ref(img, *out_hw, sharp))
        np.testing.assert_array_equal(pref.rcas_ref(e, sharp), jref.rcas_ref(e, sharp))


def test_xla_cpu_contracts_multiply_adds(rng):
    """Why the port is not bit-exact with the jitted JAX side: XLA's CPU
    compile of a·b + c rounds once (an FMA); the port rounds twice."""
    a, b, c = (rng.random(4096).astype(np.float32) for _ in range(3))
    jitted = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    fused = (a.astype(np.float64) * b + c).astype(np.float32)
    np.testing.assert_array_equal(jitted, fused)
    port = (_t(a) * _t(b) + _t(c)).numpy()
    assert not np.array_equal(port, jitted)
    np.testing.assert_array_equal(port, (a * b) + c)


@pytest.mark.parametrize(
    "s, h, w, sharp",
    [(2, 40, 48, "quality"), (3, 24, 32, "ultra"), (4, 16, 24, "performance"),
     (2, 37, 53, "balanced"), (3, 24, 32, 0.0)],
    ids=["2x-quality", "3x-ultra", "4x-performance", "2x-odd-balanced", "3x-sharp0"],
)
def test_plain_matches_pallas(rng, s, h, w, sharp):
    img = _frame(rng, h, w)
    value = sharp if isinstance(sharp, float) else JF.FSR_SHARPNESS[sharp]
    want = np.asarray(JF._fused_phase_pipeline(h, w, s, value)(img))
    got = F.fsr(_t(img), s, value).numpy()
    assert got.shape == want.shape == (s * h, s * w, 4)
    assert np.all(got[..., 3] == 255)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    ties = _cutoff_ties(img, s)
    print(f"s={s} {h}x{w} sharp={value}: max {d.max()} LSB, outside cut-off ties "
          f"{d[~ties].max()} LSB, exact {(d == 0).mean():.5f}, tie pixels {ties.mean():.4f}")
    assert d[~ties].max() <= 1
    assert ties.mean() <= TIE_SHARE_MAX


@pytest.mark.parametrize("s, h, w", [(2, 40, 48), (3, 24, 32), (4, 16, 24)])
def test_plain_vs_xla_path(rng, s, h, w):
    img = _frame(rng, h, w)
    want = np.asarray(JF.make_fsr_upscaler(h, w, s * h, s * w, "quality", impl="xla")(img))
    got = PF.make_fsr_upscaler(h, w, s * h, s * w, "quality", device="cpu")(img).numpy()
    assert psnr(got, want) >= 55.0


@pytest.mark.parametrize("s, h, w", [(2, 40, 48), (3, 24, 32), (4, 16, 24)])
@pytest.mark.parametrize("quality", ["quality", "ultra"])
def test_plain_vs_golden(rng, s, h, w, quality):
    """bench.py's psnr_fsr_db contract against easu_ref → rcas_ref, which
    packs to u8 between the passes where the fused path keeps fp32."""
    img = _frame(rng, h, w)
    sharp = JF.FSR_SHARPNESS[quality]
    golden = pref.rcas_ref(pref.easu_ref(img, s * h, s * w, sharp), sharp)
    got = F.fsr(_t(img), s, sharp).numpy()
    max_d = int(np.abs(got.astype(np.int32) - golden.astype(np.int32)).max())
    print(f"s={s} {quality}: {psnr(got, golden):.2f} dB, max {max_d} LSB")
    assert psnr(got, golden) >= 40.0 and max_d <= 12


@pytest.mark.parametrize(
    "h, w, oh, ow", [(30, 40, 45, 60), (24, 32, 48, 96), (37, 53, 50, 80)],
    ids=["1.5x", "2x-rows-3x-cols", "odd-down-up"],
)
def test_general_path_matches_jax(rng, h, w, oh, ow):
    """Non-integer or unequal scales: EASU, trunc pack to u8, RCAS, in plain
    PyTorch; `easu` and `rcas` alone equal JAX's eager functions."""
    assert PF.integer_scale(h, w, oh, ow) is None
    img = _frame(rng, h, w)
    sharp = JF.FSR_SHARPNESS["quality"]
    want = np.asarray(JF.make_fsr_upscaler(h, w, oh, ow, "quality")(img))
    got = PF.make_fsr_upscaler(h, w, oh, ow, "quality", device="cpu")(img).numpy()
    assert got.shape == (oh, ow, 4)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    np.testing.assert_array_equal(PF.easu(_t(img), oh, ow, sharp).numpy(),
                                  np.asarray(JF.easu(img, oh, ow, sharp)))
    np.testing.assert_array_equal(PF.rcas(_t(img), sharp).numpy(), np.asarray(JF.rcas(img, sharp)))


def test_rcas_flat_image_unchanged():
    img = np.full((16, 16, 4), 100, np.uint8)
    np.testing.assert_array_equal(PF.rcas(_t(img), 0.25).numpy()[..., :3], img[..., :3])


@pytest.mark.parametrize("shape", [(20, 28, 40, 56), (20, 28, 30, 42)], ids=["kernel", "general"])
def test_batched_equals_per_frame(rng, shape):
    h, w, oh, ow = shape
    frames = np.stack([_frame(rng, h, w) for _ in range(3)])
    up = PF.make_fsr_upscaler(h, w, oh, ow, "ultra", device="cpu")
    batch = up(frames)
    assert tuple(batch.shape) == (3, oh, ow, 4)
    for i in range(3):
        np.testing.assert_array_equal(batch[i].numpy(), up(frames[i]).numpy())
    np.testing.assert_array_equal(PF.fsr_upscale(frames, oh, ow, "ultra", device="cpu").numpy(),
                                  batch.numpy())
    np.testing.assert_array_equal(F.fsr_batched(_t(frames), 2, 0.25)[1].numpy(),
                                  F.fsr(_t(frames[1]), 2, 0.25).numpy())


def test_scale_routing():
    assert [PF.integer_scale(10, 20, s * 10, s * 20) for s in (1, 2, 3, 4)] == [1, 2, 3, 4]
    # above the kernel's largest scale, or unequal axes: the general path
    for shape in ((10, 20, 50, 100), (10, 20, 20, 60), (10, 20, 15, 30)):
        assert PF.integer_scale(*shape) is None


def test_wrapper_checks():
    x = torch.zeros((8, 8, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="integer scale in 1..4"):
        F.fsr(x, 5, 0.17)
    with pytest.raises(TypeError, match="uint8"):
        F.fsr(x.float(), 2, 0.17)
    with pytest.raises(ValueError, match=r"\[N, H, W, 4\]"):
        F.fsr_batched(x, 2, 0.17)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        F._launch(x[None], 2, 0.17)
    with pytest.raises(ValueError, match="expected"):
        PF.make_fsr_upscaler(8, 8, 16, 16, device="cpu")(torch.zeros((8, 9, 4), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# the slice through the API
# ---------------------------------------------------------------------------


def test_fsr_upscaler_contract(rng):
    up = pc.create_fsr_upscaler("ultra", device="cpu")
    assert isinstance(up, pc.PyFsrUpscaler)
    assert up.name == "FsrUpscaler" == nsc.create_fsr_upscaler("ultra").name
    assert up.algorithm == "bilinear" == nsc.create_fsr_upscaler("ultra").algorithm
    with pytest.raises(RuntimeError, match="Upscaler not initialized"):
        up.upscale(b"\x00" * 16)
    up.initialize(32, 24, 64, 48)
    assert up.upscale_scale == 2.0
    with pytest.raises(
        RuntimeError,
        match=r"Input data size \(100\) does not match expected input buffer size \(3072 for 32x24\)",
    ):
        up.upscale(b"\x00" * 100)
    frames = [_frame(rng, 24, 32).tobytes() for _ in range(3)]
    outs = up.upscale_batch(frames)
    assert len(outs) == 3 and all(len(o) == 64 * 48 * 4 for o in outs)
    assert outs == [up.upscale(f) for f in frames]
    fn = up._fn
    up.reload_shader("fake.wgsl")
    assert up._fn is not fn and isinstance(up._fn, PF.FsrUpscaler)
    assert up.upscale(frames[0]) == outs[0]  # still FSR, not a bilinear resample


@pytest.mark.parametrize("shape", [(32, 24, 64, 48), (30, 20, 45, 30)], ids=["2x", "1.5x"])
def test_fsr_bytes_match_jax_api(rng, shape):
    """Same bytes into nu_scaler_core's PyFsrUpscaler and the port's: the 2×
    case within the Pallas bound above (the JAX API takes its XLA path on the
    CPU: ≥ 55 dB), the 1.5× case within 1 LSB."""
    iw, ih, ow, oh = shape
    img = _frame(rng, ih, iw)
    outs = []
    for up in (pc.PyFsrUpscaler("quality", device="cpu"), nsc.PyFsrUpscaler("quality")):
        up.initialize(iw, ih, ow, oh)
        outs.append(np.frombuffer(up.upscale(img.tobytes()), np.uint8).reshape(oh, ow, 4))
    if PF.integer_scale(ih, iw, oh, ow) is None:
        assert np.abs(outs[0].astype(np.int32) - outs[1].astype(np.int32)).max() <= 1
    else:
        assert psnr(outs[0], outs[1]) >= 55.0


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.create_fsr_upscaler("quality")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PF.make_fsr_upscaler(8, 8, 16, 16)
