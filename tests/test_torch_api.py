"""API contract of the port (nu_scaler_tpu_torch.core) on the CPU, mirroring
tests/test_api.py: error strings, scale clamps, byte lengths, and the same
bytes as the JAX `nu_scaler_core` classes up to a stated bound."""

import numpy as np
import pytest

import nu_scaler_core as nsc
from nu_scaler_tpu.kernels import reference as jref
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch import core as pc


def _up(*args, **kw):
    return pc.PyWgpuUpscaler(*args, device="cpu", **kw)


def test_module_surface():
    for name in ["PyWgpuUpscaler", "WgpuFrameInterpolator", "create_interpolator", "UpscalingQuality",
                 "QUALITY_ULTRA", "QUALITY_QUALITY", "QUALITY_BALANCED", "QUALITY_PERFORMANCE"]:
        assert hasattr(pc, name), f"missing export: {name}"


def test_basic_upscale_flow(pattern):
    """The test_basic.py acceptance path: 320x240 gradient → 2x bilinear."""
    img = pattern(320, 240)
    up = _up("quality", "bilinear")
    up.initialize(320, 240, 640, 480)
    out = up.upscale(img.tobytes())
    assert isinstance(out, bytes) and len(out) == 640 * 480 * 4
    out_arr = np.frombuffer(out, np.uint8).reshape(480, 640, 4)
    assert psnr(out_arr, jref.bilinear_ref(img, 480, 640)) >= 50.0


@pytest.mark.parametrize(
    "quality, algorithm, want",
    [
        ("quality", "nearest", "nearest"),
        ("bogus-quality", "bogus-algo", "nearest"),
        ("ultra", "lanczos3", "lanczos3"),
        ("balanced", "Catmull-Rom", "bicubic"),
        (pc.QUALITY_ULTRA, "bilinear", "bilinear"),
    ],
)
def test_ctor_defaults_and_fallbacks(quality, algorithm, want):
    up = _up(quality, algorithm)
    assert up.algorithm == want
    assert up.algorithm == nsc.PyWgpuUpscaler(quality, algorithm).algorithm
    assert up._quality == nsc.PyWgpuUpscaler(quality, algorithm)._quality
    assert up.name == "WgpuUpscaler" and up.upscale_scale == 2.0


def test_scale_clamp():
    up = _up()
    for scale in (1.0, 3.5, 4.0):
        up.upscale_scale = scale
        assert up.upscale_scale == scale
    for scale in (0.5, 4.5):
        with pytest.raises(ValueError, match="Scale factor must be between 1.0 and 4.0"):
            up.upscale_scale = scale
    assert up.upscale_scale == 4.0


def test_initialize_sets_mean_scale():
    up = _up()
    up.initialize(100, 100, 300, 100)  # ws=3, hs=1 → mean 2
    assert up.upscale_scale == pytest.approx(2.0)
    with pytest.raises(RuntimeError, match="Invalid dimensions: all must be positive"):
        up.initialize(0, 10, 20, 20)


def test_uninitialized_error():
    with pytest.raises(RuntimeError, match="Upscaler not initialized"):
        _up().upscale(b"\x00" * 16)


def test_size_mismatch_error():
    up = _up("quality", "nearest")
    up.initialize(32, 24, 64, 48)
    with pytest.raises(
        RuntimeError,
        match=r"Input data size \(100\) does not match expected input buffer size \(3072 for 32x24\)",
    ):
        up.upscale(b"\x00" * 100)


def test_upscale_batch(pattern):
    up = _up("quality", "bilinear")
    up.initialize(32, 24, 64, 48)
    frames = [pattern(32, 24).tobytes(), bytes(range(256)) * 12, b"\x07" * 3072, pattern(32, 24).tobytes()]
    outs = up.upscale_batch(frames)
    assert len(outs) == 4
    assert all(isinstance(o, bytes) and len(o) == 64 * 48 * 4 for o in outs)
    assert [o for o in outs] == [up.upscale(f) for f in frames]


def test_compat_knobs(tmp_path):
    up = _up()
    up.set_thread_count(8)
    up.set_buffer_pool_size(4)
    up.set_gpu_allocator("aggressive")
    up.initialize(16, 16, 32, 32)
    fn = up._fn
    up.reload_shader(str(tmp_path / "fake.wgsl"))  # recompile hook, no error
    assert up._fn is not fn  # rebuilt for this instance only
    out = up.upscale(b"\x01" * (16 * 16 * 4))
    assert len(out) == 32 * 32 * 4
    assert up._thread_count == 8 and up._buffer_pool_size == 4 and up._gpu_allocator == "aggressive"


@pytest.mark.parametrize("algo", ["nearest", "bilinear", "lanczos3"])
def test_upscale_bytes_match_jax_api(rng, algo):
    """Same bytes in, bytes out within 2 LSB of nu_scaler_core (its XLA path
    rounds the vertical pass to bf16); nearest is bit-exact."""
    img = rng.integers(0, 256, (24, 32, 4), np.uint8)
    outs = []
    for up in (_up("ultra", algo), nsc.PyWgpuUpscaler("ultra", algo)):
        up.initialize(32, 24, 64, 48)
        outs.append(np.frombuffer(up.upscale(img.tobytes()), np.uint8))
    d = np.abs(outs[0].astype(np.int32) - outs[1].astype(np.int32))
    assert d.max() <= (0 if algo == "nearest" else 2)


def test_interpolator_parity():
    """test_interpolator.py acceptance: red/blue square blend at 64x64."""
    interp = pc.WgpuFrameInterpolator(device="cpu")
    a = np.zeros((64, 64, 4), np.uint8)
    a[..., 0] = 255
    a[..., 3] = 255
    b = np.zeros((64, 64, 4), np.uint8)
    b[..., 2] = 255
    b[..., 3] = 255
    out = interp.interpolate_py(a.tobytes(), b.tobytes(), 64, 64, time_t=0.5)
    assert len(out) == 64 * 64 * 4
    arr = np.frombuffer(out, np.uint8).reshape(64, 64, 4)
    assert np.all(arr[..., 0] == 128) and np.all(arr[..., 2] == 128)


@pytest.mark.parametrize("t", [0.5, 1 / 3, 0.9])
def test_interpolator_bytes_match_jax_api(rng, t):
    """The port runs blend_only as the JAX function is written (eager); the
    JAX API runs it jit-compiled, which moves exact-half ties by 1. So: equal
    everywhere except ±1 on ties."""
    a = rng.integers(0, 256, (20, 36, 4), np.uint8)
    b = rng.integers(0, 256, (20, 36, 4), np.uint8)
    port = pc.WgpuFrameInterpolator(device="cpu").interpolate_py(a.tobytes(), b.tobytes(), 36, 20, time_t=t)
    jax_out = nsc.WgpuFrameInterpolator().interpolate_py(a.tobytes(), b.tobytes(), 36, 20, time_t=t)
    assert len(port) == len(jax_out) == 20 * 36 * 4
    d = np.frombuffer(port, np.uint8).astype(np.int32) - np.frombuffer(jax_out, np.uint8)
    mix = a.astype(np.float64) + (b.astype(np.float64) - a) * np.float32(t)
    tie = np.abs(mix - np.floor(mix) - 0.5).ravel() < 1e-4
    assert np.abs(d).max() <= 1
    assert np.all((d == 0) | tie)


def test_interpolator_size_validation():
    interp = pc.WgpuFrameInterpolator(device="cpu")
    with pytest.raises(
        ValueError,
        match=r"Expected 16384 bytes per frame for 64x64x4 RGBA, got frame_a: 100 bytes, frame_b: 16384 bytes",
    ):
        interp.interpolate_py(b"\x00" * 100, b"\x00" * 16384, 64, 64)


def test_interpolator_presets():
    for preset, want in (("16x16", (16, 16)), ("wide", (32, 8)), ("bogus", (32, 8)), (None, (32, 8))):
        assert pc.WgpuFrameInterpolator(preset, device="cpu").workgroup_preset == want


@pytest.mark.parametrize(
    "mode, item", [("flow", 8), ("flow_soft_ref", 10), ("flow_exact", 8)]
)
def test_interpolator_flow_modes_not_ported(mode, item):
    """The modes not ported yet raise, naming their ROADMAP item; flow_soft
    and blend construct; an unknown mode is a ValueError."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, item {item}\\b"):
        pc.WgpuFrameInterpolator(mode=mode, device="cpu")
    for ported in ("blend", "flow_soft"):
        assert pc.WgpuFrameInterpolator(mode=ported, device="cpu").mode == ported
    with pytest.raises(ValueError, match="unknown interpolation mode"):
        pc.WgpuFrameInterpolator(mode="bogus", device="cpu")


@pytest.mark.parametrize(
    "preset", ["8x8", "square16x16", "wide32x8", "wide", "tall8x32", "TALL", "bogus", None]
)
def test_interpolator_warp_tile_matches_core(preset):
    """Workgroup preset → warp tile (rows = preset y, cols = 4·preset x),
    as nu_scaler_core/interpolator.py:53-65 maps it."""
    got = pc.WgpuFrameInterpolator(preset, device="cpu")
    want = nsc.WgpuFrameInterpolator(preset)
    assert got.workgroup_preset == want.workgroup_preset
    assert got.warp_tile == want.warp_tile
