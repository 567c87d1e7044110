"""API contract of the port (nu_scaler_tpu_torch.core) on the CPU, mirroring
tests/test_api.py: error strings, scale clamps, byte lengths, and the same
bytes as the JAX `nu_scaler_core` classes up to a stated bound."""

import numpy as np
import pytest
import torch

import nu_scaler_core as nsc
from nu_scaler_tpu.kernels import reference as jref
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch import core as pc


def _up(*args, **kw):
    return pc.PyWgpuUpscaler(*args, device="cpu", **kw)


def test_module_surface():
    for name in ["PyWgpuUpscaler", "WgpuFrameInterpolator", "create_interpolator", "UpscalingQuality",
                 "QUALITY_ULTRA", "QUALITY_QUALITY", "QUALITY_BALANCED", "QUALITY_PERFORMANCE",
                 "PyAdvancedWgpuUpscaler", "PyVramStats", "create_advanced_upscaler",
                 "create_best_upscaler"]:
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
    "mode, item", [("flow", None), ("flow_soft_ref", 10), ("flow_exact", None)]
)
def test_interpolator_flow_modes_not_ported(mode, item):
    """Every motion mode constructs and serves a mid frame (none is left
    unported: flow_soft_ref, ROADMAP queue 1 item 10, serves the flow_soft
    mid refined by the learned net); flow_soft and blend construct; an
    unknown mode is a ValueError."""
    from nu_scaler_tpu_torch.models import interp_refine as pir
    from nu_scaler_tpu_torch.ops import interpolate as pint

    interp = pc.WgpuFrameInterpolator(mode=mode, device="cpu")
    assert interp.mode == mode
    a = np.random.default_rng(3).integers(0, 256, (16, 128, 4), np.uint8)
    b = np.roll(a, 2, axis=1)
    out = interp.interpolate_py(a.tobytes(), b.tobytes(), 128, 16)
    assert len(out) == 16 * 128 * 4
    if item is not None:
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        soft = pint.make_interpolator(16, 128, "flow_soft", "cpu")(ta, tb, 0.5)
        assert out == pir.refine_mid(ta, tb, soft, device="cpu").numpy().tobytes()
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


# -- PyAdvancedWgpuUpscaler: the learned "ultra" tier and the adaptive ladder


def _ultra(w=32, h=32, ow=64, oh=64, quality="ultra"):
    up = pc.create_advanced_upscaler(quality, device="cpu")
    up.learned_prefer = "ultra"
    up.initialize(w, h, ow, oh)
    return up


def test_advanced_ultra_serves_the_learned_tier(rng):
    """create_advanced_upscaler("ultra") with learned_prefer = "ultra" gives
    the bytes of the served function (tpu4b2 at x2, tpu4 at x4)."""
    from nu_scaler_tpu_torch.models import esrgan_lite as pel

    for (w, h, ow, oh), arch in (((64, 32, 128, 64), "tpu4b2"), ((32, 16, 128, 64), "tpu4")):
        up = _ultra(w, h, ow, oh)
        assert up._serving_tier == "learned" and up._fn.arch == arch
        assert up.upscale_scale == ow / w
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        want = pel.make_pretrained_upscaler(h, w, oh, ow, "ultra", device="cpu")(img).numpy().tobytes()
        assert up.upscale(img.tobytes()) == want
        assert torch.equal(up.upscale_arr(img), torch.from_numpy(np.frombuffer(want, np.uint8).reshape(oh, ow, 4).copy()))


def test_advanced_learned_batch_equals_frames(rng):
    up = _ultra(64, 32, 128, 64)
    frames = [rng.integers(0, 256, (32, 64, 4), np.uint8).tobytes() for _ in range(3)]
    outs = up.upscale_batch(frames)
    assert len(outs) == 3 and all(len(o) == 128 * 64 * 4 for o in outs)
    assert outs == [up.upscale(f) for f in frames]


def test_advanced_adaptive_downgrade_swaps_serving_tier(pattern, monkeypatch):
    """As tests/test_api.py checks the JAX class: pressure above 85% steps
    ultra → quality (the learned net swapped for the classical kernel) →
    balanced; below 50% back up to the requested tier, never beyond."""
    import types

    up = _ultra()
    assert up._serving_tier == "learned"
    learned_fn = up._fn
    fake = types.SimpleNamespace(usage_percent=95.0, total_mb=100.0, used_mb=95.0, free_mb=5.0,
                                 app_allocated_mb=0.0)
    monkeypatch.setattr(up._pool, "get_vram_stats", lambda: fake)
    up.upscale(pattern(32, 32).tobytes())
    assert up.get_quality_str() == "quality" and up.recommended_quality == pc.QUALITY_QUALITY
    assert up._serving_tier == "classical" and up._fn is not learned_fn
    out = up.upscale(pattern(32, 32).tobytes())
    assert len(out) == 64 * 64 * 4
    assert up.get_quality_str() == "balanced"
    fake.usage_percent, fake.used_mb = 30.0, 30.0
    up.upscale(pattern(32, 32).tobytes())  # balanced -> quality
    up.upscale(pattern(32, 32).tobytes())  # quality -> ultra (the requested tier)
    assert up.get_quality_str() == "ultra" and up._serving_tier == "learned"
    up.upscale(pattern(32, 32).tobytes())
    assert up.get_quality_str() == "ultra"  # never beyond the requested tier


def test_advanced_adaptive_upgrade_capped_at_requested(pattern, monkeypatch):
    import types

    up = pc.PyAdvancedWgpuUpscaler("balanced", "bilinear", True, device="cpu")
    up.initialize(16, 16, 32, 32)
    fake = types.SimpleNamespace(usage_percent=20.0, total_mb=100.0, used_mb=20.0, free_mb=80.0,
                                 app_allocated_mb=0.0)
    monkeypatch.setattr(up._pool, "get_vram_stats", lambda: fake)
    up.upscale(pattern(16, 16).tobytes())
    assert up.get_quality_str() == "balanced" and up._serving_tier == "classical"


@pytest.mark.parametrize("prefer, sizes, arch", [
    ("quality", (30, 30, 60, 60), "tpu"),          # the default ladder, stride 4 does not divide 30
    ("performance", (32, 32, 96, 96), "tpu4"),     # x3 lands on no exact ratio: x4, resized
    ("ultra", (32, 32, 96, 96), "tpu4"),
    ("ultra", (30, 30, 60, 60), "tpu"),            # stride 4 does not divide 30: the stride-2 arch
    ("quality", (31, 31, 62, 62), "lite"),         # odd sides: ESRGANLite
])
def test_advanced_unported_learned_requests_raise(rng, prefer, sizes, arch):
    """The learned requests that raised before the rest of the ladder was
    ported serve at initialize, as nu_scaler_core's class does: the JAX
    ladder's arch ("performance" through make_fast_upscaler), the bytes of
    the served function, and no classical stand-in."""
    import nu_scaler_tpu.models.esrgan_lite as el
    from nu_scaler_tpu_torch.models import esrgan_lite as pel

    up = pc.create_advanced_upscaler("ultra", device="cpu")
    up.learned_prefer = prefer
    w, h, ow, oh = sizes
    up.initialize(*sizes)
    jfn = el.make_fast_upscaler(h, w, oh, ow) if prefer == "performance" else \
        el.make_pretrained_upscaler(h, w, oh, ow, prefer=prefer)
    assert up._serving_tier == "learned" and up._fn.arch == arch == jfn.arch
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    want = pel.make_pretrained_upscaler(h, w, oh, ow, prefer, device="cpu")(img)
    out = up.upscale(img.tobytes())
    assert len(out) == ow * oh * 4 and out == want.numpy().tobytes()


@pytest.mark.parametrize("prefer, sizes, arch", [
    (None, (64, 32, 128, 64), "tpu4b2"),         # the default learned_prefer, "quality": x2
    (None, (32, 16, 128, 64), "tpu4"),           # x4: the int8 trunk, bf16 head, fp32 base
    ("performance", (64, 32, 128, 64), "tpu4b1"),
])
def test_advanced_int8_ladders_serve(rng, prefer, sizes, arch):
    """create_advanced_upscaler("ultra") with the default learned_prefer
    ("quality") or "performance" serves the int8 ladder: the bytes of the
    served function, quantized, and upscale_batch through the same graph."""
    from nu_scaler_tpu_torch.models import esrgan_lite as pel

    up = pc.create_advanced_upscaler("ultra", device="cpu")
    assert up.learned_prefer == "quality"
    if prefer is not None:
        up.learned_prefer = prefer
    w, h, ow, oh = sizes
    up.initialize(*sizes)
    assert up._serving_tier == "learned" and (up._fn.arch, up._fn.quantized) == (arch, True)
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    want = pel.make_pretrained_upscaler(h, w, oh, ow, prefer=up.learned_prefer, device="cpu")(img)
    assert up.upscale(img.tobytes()) == want.numpy().tobytes()
    assert up.upscale_batch([img.tobytes()] * 2) == [want.numpy().tobytes()] * 2


def test_advanced_failed_learned_build_raises(monkeypatch):
    """A failed learned build raises from initialize and leaves the upscaler
    uninitialised: no classical stand-in (nu_scaler_core's class warns and
    keeps its classical kernel instead)."""
    from nu_scaler_tpu_torch.models import esrgan_lite as pel

    def broken(*args, **kwargs):
        raise RuntimeError("learned build failed")

    for name in ("make_pretrained_upscaler", "make_fast_upscaler"):
        monkeypatch.setattr(pel, name, broken)
    for prefer in ("quality", "performance"):
        up = pc.create_advanced_upscaler("ultra", device="cpu")
        up.learned_prefer = prefer
        with pytest.raises(RuntimeError, match="learned build failed"):
            up.initialize(64, 32, 128, 64)
        assert up._serving_tier == "classical" and not up._initialized
        with pytest.raises(RuntimeError, match="not initialized"):
            up.upscale(bytes(64 * 32 * 4))


def test_advanced_classical_tier_matches_core(rng):
    """Below ultra the advanced class runs the bilinear resample, as
    nu_scaler_core's does (within the resample's 2 LSB bound)."""
    img = rng.integers(0, 256, (24, 32, 4), np.uint8)
    outs = []
    for up in (pc.create_advanced_upscaler("quality", device="cpu"), nsc.create_advanced_upscaler("quality")):
        up.initialize(32, 24, 64, 48)
        assert up._serving_tier == "classical" and up.upscale_scale == 2.0
        outs.append(np.frombuffer(up.upscale(img.tobytes()), np.uint8).astype(np.int32))
    assert np.abs(outs[0] - outs[1]).max() <= 2


def test_advanced_stats_and_info_keys():
    up = pc.create_best_upscaler("balanced", device="cpu")
    ref = nsc.create_best_upscaler("balanced")
    up.initialize(16, 16, 32, 32)
    ref.initialize(16, 16, 32, 32)
    assert sorted(up.get_gpu_info()) == sorted(ref.get_gpu_info())
    s = up.get_vram_stats()
    assert isinstance(s, pc.PyVramStats) and s.total_mb > 0 and s.free_mb <= s.total_mb
    assert 0.0 <= up.get_vram_usage_percent() <= 100.0 and "PyVramStats(total_mb=" in repr(s)
    assert up.get_native_device_handle() == torch.device("cpu")
    assert up._pool.strategy.value == "aggressive"  # a 16x16 frame
    up.initialize(2560, 1440, 5120, 2880)
    assert up._pool.strategy.value == "balanced"
    up.set_memory_strategy("bogus")
    assert up._pool.strategy.value == "balanced"
    up.adaptive_quality = False
    assert not up.adaptive_quality
    up.quality = "Performance"
    assert up.quality == "performance" and up._requested_quality == pc.QUALITY_PERFORMANCE
    for call in (up.cleanup_memory, up.force_cleanup, up.update_gpu_stats, up.force_gpu_activation):
        call()


@pytest.mark.parametrize("pct, level", [(0.0, "Low"), (49.9, "Low"), (50.0, "Medium"), (74.9, "Medium"),
                                        (75.0, "High"), (89.9, "High"), (90.0, "Critical")])
def test_memory_pressure_thresholds_match_jax(pct, level):
    from nu_scaler_tpu.runtime import memory as jmem
    from nu_scaler_tpu_torch.runtime import memory as pmem

    assert pmem.MemoryPressure.from_percent(pct).value == level
    assert jmem.MemoryPressure.from_percent(pct).value == level


def test_detector_lists_the_host():
    from nu_scaler_tpu_torch.runtime import detector

    det = detector.DeviceDetector()
    infos = det.detect_gpus()
    assert infos[-1].platform == "cpu" and det.get_primary_device() is not None
    if not torch.cuda.is_available():
        assert det.get_primary_device() == torch.device("cpu")
        assert det.determine_best_upscaling_technology() == "fallback"
    assert set(infos[-1].as_dict()) == {"name", "vendor", "device_type", "backend", "vendor_id",
                                        "device_id", "driver_info", "is_discrete"}
