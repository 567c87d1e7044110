"""The port's technology registry (`nu_scaler_tpu_torch/core/technologies.py`)
against `nu_scaler_core/technologies.py` on the CPU: the enum, the support
probes, the reference's fallback chains (as tests/test_technologies.py
holds them), NIS and the image-file round trip."""

import numpy as np
import pytest
import torch

from nu_scaler_core import technologies as jtech
from nu_scaler_tpu_torch import core as pc
from nu_scaler_tpu_torch.core import technologies as tech


def test_enum_and_quality_map_equal_jax():
    assert tech.TECHNOLOGIES == jtech.TECHNOLOGIES
    for q in ("ultra", "quality", "balanced", "performance", "bogus"):
        assert tech._quality_to_algorithm(q) == jtech._quality_to_algorithm(q)


def test_module_exports():
    for name in ("create_upscaler", "is_supported", "upscale_image_file", "NISUpscaler",
                 "PassThroughUpscaler"):
        assert getattr(pc, name) is getattr(tech, name)


def test_is_supported_probes_are_real(monkeypatch):
    """Classical tiers need their device (the CPU when asked for), learned
    tiers also the committed weights of their ladder."""
    for t in ("fsr", "fsr3", "nis", "cuda", "vulkan", "gpu", "fallback", "none", "dlss", "xess"):
        assert tech.is_supported(t, "cpu") == jtech.is_supported(t), t
    assert not tech.is_supported("not-a-tech", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not tech.is_supported("fsr") and not tech.is_supported("dlss")
    assert tech.is_supported("none") and tech.is_supported("fallback")
    monkeypatch.setattr(tech._learned, "WEIGHTS_DIR", tech._learned.WEIGHTS_DIR / "missing")
    assert not tech.is_supported("dlss", "cpu") and not tech.is_supported("xess", "cpu")


@pytest.mark.parametrize("technology, quality", [
    ("none", "ultra"), ("fallback", "ultra"), ("fallback", "performance"), ("fsr", "quality"),
    ("fsr3", "quality"), ("fsr3", "balanced"), ("dlss", "ultra"), ("dlss", "balanced"),
    ("xess", "balanced"), ("nis", "balanced"), ("cuda", "quality"), ("gpu", "quality"),
    ("vulkan", "quality"),
])
def test_chains_resolve_as_jax(technology, quality):
    """Every chain resolves to the same class, name, algorithm, quality and
    learned ladder as the JAX registry's on the same request."""
    got = tech.create_upscaler(technology, quality, device="cpu")
    want = jtech.create_upscaler(technology, quality)
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name and got.algorithm == want.algorithm
    assert got._quality.value == want._quality.value
    if isinstance(got, pc.PyAdvancedWgpuUpscaler):
        assert got.learned_prefer == getattr(want, "learned_prefer", "quality")
        assert got.get_quality_str() == "ultra"


def test_unsupported_chains_fall_back_in_order(monkeypatch):
    """Without the learned weights, XeSS falls to FSR, DLSS to FSR; without
    a device too, every chain ends at the basic upscaler (mod.rs:121-196)."""
    monkeypatch.setattr(tech._learned, "WEIGHTS_DIR", tech._learned.WEIGHTS_DIR / "missing")
    assert tech.create_upscaler("xess", "balanced", device="cpu").name == "FsrUpscaler"
    assert tech.create_upscaler("dlss", "ultra", device="cpu").name == "FsrUpscaler"
    monkeypatch.setattr(tech, "_device_available", lambda device=None: False)
    for t in ("fsr", "fsr3", "dlss", "xess", "nis", "cuda", "gpu", "vulkan"):
        up = tech.create_upscaler(t, "ultra", device="cpu")
        assert up.name == "WgpuUpscaler" and up.algorithm == "lanczos3", t


def test_passthrough_clones_input():
    up = tech.create_upscaler("none", device="cpu")
    assert up.name == "Pass-through" and not up.needs_initialization()
    up.initialize(8, 6, 999, 999)  # output size ignored (common.rs:17-20)
    assert (up.output_width, up.output_height) == (8, 6)
    data = bytes(range(8 * 6 * 4 // 8)) * 8
    assert up.upscale(data) == data


def test_explicit_algorithm_overrides_the_quality_map():
    assert tech.create_upscaler("fallback", "ultra", algorithm="nearest", device="cpu").algorithm == "nearest"


@pytest.mark.parametrize("quality, sizes", [("balanced", (16, 12, 32, 24)), ("ultra", (20, 14, 30, 21))])
def test_nis_equals_jax(quality, sizes):
    """NIS is the quality's resample then RCAS: within the resample's 2 LSB
    bound (tests/test_torch_resample.py) of the JAX registry's NIS, alpha
    255 as RCAS packs it, and not the plain resample."""
    w, h, ow, oh = sizes
    frame = np.random.default_rng(w).integers(0, 256, (h, w, 4), np.uint8)
    outs = []
    for up in (tech.create_upscaler("nis", quality, device="cpu"), jtech.create_upscaler("nis", quality)):
        assert up.name == "NISUpscaler"
        up.initialize(w, h, ow, oh)
        outs.append(np.frombuffer(up.upscale(frame.tobytes()), np.uint8).reshape(oh, ow, 4))
    got, want = outs
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
    assert np.all(got[..., 3] == 255)
    plain = pc.PyWgpuUpscaler(quality, tech._quality_to_algorithm(quality), device="cpu")
    plain.initialize(w, h, ow, oh)
    assert plain.upscale(frame.tobytes()) != got.tobytes()


def test_dlss_serves_the_learned_tier():
    """DLSS at "ultra" quality serves the learned "quality" ladder at
    initialize (tpu4b2 int8 at x2), as the JAX registry's does."""
    up = tech.create_upscaler("dlss", "ultra", device="cpu")
    up.initialize(64, 32, 128, 64)
    assert up._serving_tier == "learned" and (up._fn.arch, up._fn.quantized) == ("tpu4b2", True)


def test_upscale_image_file_roundtrip(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    src, dst = tmp_path / "in.png", tmp_path / "out.png"
    Image.fromarray(rng.integers(0, 256, (12, 16, 4), np.uint8), "RGBA").save(src)
    assert tech.upscale_image_file(str(src), str(dst), "fallback", "performance", 2.0, device="cpu") == (32, 24)
    got = np.asarray(Image.open(dst))
    ref_dst = tmp_path / "ref.png"
    jtech.upscale_image_file(str(src), str(ref_dst), "fallback", "performance", 2.0)
    want = np.asarray(Image.open(ref_dst))
    assert got.shape == want.shape == (24, 32, 4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
