"""The port's capture classes and `NuScaler` facade (core/capture.py,
core/facade.py) against the JAX package's (`nu_scaler_core/capture.py`,
`nu_scaler_core/facade.py`), on the CPU: the same capture targets, the same
upscaler for every technology and quality, and `capture_and_upscale` within
2 LSB of JAX's bytes on the same captured frame (the bilinear resample
within 1 LSB, as tests/test_torch_resample.py holds it, with a margin of one
for the fp32 sums' order)."""

import dataclasses

import numpy as np
import pytest

import nu_scaler_core as nsc
from nu_scaler_tpu_torch import core as pc
from nu_scaler_tpu_torch.capture import sources as psrc
from nu_scaler_tpu_torch.core import facade as pfacade

MAX_LSB = 2


@pytest.mark.parametrize("kind", ["FullScreen", "WindowByTitle", "Region"])
@pytest.mark.parametrize("given", [False, True])
def test_to_internal_equals_jax(kind, given):
    """Each variant, with and without its window or region: a missing
    window is an empty title, a missing region the zero region."""
    window = (pc.PyWindowByTitle("video:clip.y4m"), nsc.PyWindowByTitle("video:clip.y4m")) if given else (None, None)
    region = (pc.PyRegion(3, 4, 50, 60), nsc.PyRegion(3, 4, 50, 60)) if given else (None, None)
    port = getattr(pc.PyCaptureTarget, kind).to_internal(window[0], region[0])
    jax_side = getattr(nsc.PyCaptureTarget, kind).to_internal(window[1], region[1])
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_side)
    assert repr(getattr(pc.PyCaptureTarget, kind)) == repr(getattr(nsc.PyCaptureTarget, kind))


def test_py_screen_capture_start_errors(monkeypatch):
    """`start` turns the capture stack's errors into RuntimeError, as JAX's
    does: a region outside the screen is empty."""
    monkeypatch.delenv("DISPLAY", raising=False)
    cap = pc.PyScreenCapture()
    assert cap.list_windows() == nsc.PyScreenCapture.list_windows() == ["Synthetic Desktop"]
    with pytest.raises(RuntimeError, match="empty capture region"):
        cap.start(pc.PyCaptureTarget.Region, None, pc.PyRegion(5000, 0, 10, 10))
    assert cap.get_frame() is None
    cap.stop()


CASES = [(t, q) for t in ("wgpu", "fsr", "dlss") for q in ("ultra", "quality", "balanced", "performance")] + [
    ("nis", "quality"), ("bogus", "quality"), ("fallback", "balanced")]


@pytest.mark.parametrize("technology,quality", CASES)
def test_nuscaler_maps_technologies_as_jax(technology, quality, capsys):
    """The upscaler class, name, quality and learned ladder of every
    technology and quality, as JAX's facade builds them."""
    port = pc.NuScaler(technology, quality, device="cpu")
    jax_side = nsc.NuScaler(technology, quality)
    for ns in (port, jax_side):
        ns.close()
    assert (port.technology, port.quality) == (jax_side.technology, jax_side.quality)
    assert type(port.upscaler).__name__ == type(jax_side.upscaler).__name__
    assert port.get_upscaler_name() == jax_side.get_upscaler_name()
    # JAX's upscaler reads a learned_prefer it was not given as "quality"
    # (nu_scaler_core/upscaler.py:243); the port's starts at "quality"
    if type(port.upscaler).__name__ == "PyAdvancedWgpuUpscaler":
        assert port.upscaler.learned_prefer == getattr(jax_side.upscaler, "learned_prefer", "quality")
    assert port.upscaler._quality.value == jax_side.upscaler._quality.value
    assert port.upscaler.device.type == "cpu"
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].startswith("[NuScaler] Using upscaler: ")


def test_nuscaler_defaults_and_setters():
    """Auto technology from the port's detector ("fallback" without a card),
    `with_technology`, `set_quality`, `list_windows`, `get_gpu_info`."""
    ns = pc.NuScaler(device="cpu")
    assert ns.technology == "fallback" and ns.get_upscaler_name() == nsc.NuScaler().get_upscaler_name()
    assert ns.get_gpu_info().platform == "cpu" and ns.list_windows() == ["Synthetic Desktop"]
    fsr = pc.NuScaler.with_technology("fsr", "quality", device="cpu")
    assert fsr.get_upscaler_name() == "FsrUpscaler"
    fsr.set_quality("performance")
    assert fsr.quality == "performance"
    dlss = pc.NuScaler("dlss", "quality", device="cpu")
    dlss.set_quality("balanced")
    assert dlss.upscaler.quality == "balanced"


def test_capture_and_upscale_equals_jax(monkeypatch):
    """One-shot capture → upscale of the FullScreen target (the synthetic
    desktop, shrunk to 64×48 here) at ×2: the bytes of the frame it
    captured, upscaled by JAX's facade, within MAX_LSB; then its two
    errors."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setattr(psrc.SyntheticSource.__init__, "__defaults__", (64, 48, 4.0))
    ns = pc.NuScaler("wgpu", "quality", device="cpu")
    ns.set_capture_target(pc.PyCaptureTarget.FullScreen)
    captured = []
    get_frame = ns.capture.get_frame

    def spy():
        got = get_frame()
        if got is not None:
            captured.append(got)
        return got

    monkeypatch.setattr(ns.capture, "get_frame", spy)
    try:
        out = ns.capture_and_upscale(64, 48, 128, 96)
        data, w, h = captured[-1]
        assert (w, h) == (64, 48) and len(out) == 128 * 96 * 4
        jax_ns = nsc.NuScaler("wgpu", "quality")
        jax_ns.upscaler.initialize(64, 48, 128, 96)
        want = np.frombuffer(jax_ns.upscaler.upscale(data), np.uint8)
        got = np.frombuffer(out, np.uint8)
        assert np.abs(got.astype(int) - want).max() <= MAX_LSB
        np.testing.assert_array_equal(got, np.frombuffer(ns.upscaler.upscale(data), np.uint8))
        with pytest.raises(RuntimeError, match="Captured frame is 64x48, expected 66x48"):
            ns.capture_and_upscale(66, 48, 132, 96)
        monkeypatch.setattr(ns.capture, "get_frame", lambda: None)
        monkeypatch.setattr(pfacade, "FIRST_FRAME_WAIT_S", 0.05)
        with pytest.raises(RuntimeError, match="No frame captured"):
            ns.capture_and_upscale(64, 48, 128, 96)
    finally:
        ns.close()
    assert not ns._capturing
