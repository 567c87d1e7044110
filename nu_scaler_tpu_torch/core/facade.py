"""`NuScaler` engine facade of the port — the counterpart of
`nu_scaler_core/facade.py`, parity with the Rust-side struct
(`nu_scaler_core/src/lib.rs:856-987`): detect the devices, build the best
(or requested) upscaler on `device` (the card unless "cpu"), own a capture
session, and expose one-shot `capture_and_upscale`."""

from __future__ import annotations

import time
from typing import Optional

from nu_scaler_tpu_torch.constants import UpscalingQuality
from nu_scaler_tpu_torch.core.capture import PyCaptureTarget, PyScreenCapture
from nu_scaler_tpu_torch.core.technologies import create_upscaler
from nu_scaler_tpu_torch.core.upscaler import PyAdvancedWgpuUpscaler, PyFsrUpscaler, PyWgpuUpscaler
from nu_scaler_tpu_torch.runtime.detector import detect

# how long capture_and_upscale waits for the producer's first frame
FIRST_FRAME_WAIT_S = 0.5


def _create_upscaler(technology: str, quality: str, device=None):
    """UpscalerFactory::create_upscaler role (upscale/mod.rs:93-148)."""
    t = (technology or "").lower()
    if t == "fsr":
        return PyFsrUpscaler(quality, device)
    if t in ("dlss", "wgpu"):
        # "dlss" maps to the learned tier via the advanced upscaler's ultra
        # quality; plain wgpu keeps the requested quality. A dlss request at
        # performance/balanced quality serves the fast learned ladder
        # ("performance") instead of the quality-first one.
        q = "ultra" if t == "dlss" else quality
        up = PyAdvancedWgpuUpscaler(q, "bilinear", True, device)
        if t == "dlss":
            ql = (quality or "").lower()
            if ql in ("performance", "balanced"):
                up.learned_prefer = "performance"
            elif ql == "ultra":
                # the held-out quality peak (tpu4) — slower, max fidelity
                up.learned_prefer = "ultra"
        return up
    if t in ("none", "fsr3", "xess", "nis", "cuda", "vulkan", "gpu"):
        # legacy G1 technologies — resolved through the registry's fallback
        # chains (core/technologies.py; Nu_scale/src/upscale/mod.rs:92-270)
        return create_upscaler(t, quality, device=device)
    return PyWgpuUpscaler(quality, "nearest", device)  # fallback


class NuScaler:
    """Engine facade (lib.rs:856-987)."""

    def __init__(self, technology: Optional[str] = None, quality: str = "balanced", device=None):
        det = detect()
        self.gpu_info = det.get_primary_gpu()
        self.technology = (
            technology or det.determine_best_upscaling_technology()
        ).lower()
        self.quality = UpscalingQuality.parse(quality).value
        self.upscaler = _create_upscaler(self.technology, self.quality, device)
        self.capture = PyScreenCapture()
        self._capture_target = PyCaptureTarget.FullScreen
        self._capturing = False
        print(
            f"[NuScaler] Using upscaler: {self.upscaler.name} "
            f"(Technology: {self.technology})"
        )

    @staticmethod
    def with_technology(technology: str, quality: str = "balanced", device=None) -> "NuScaler":
        """lib.rs:893-... explicit-tech constructor."""
        return NuScaler(technology, quality, device)

    # -- capture plumbing (lib.rs:923-941) --------------------------------

    def list_windows(self):
        return PyScreenCapture.list_windows()

    def set_capture_target(self, target) -> None:
        self._capture_target = target
        if self._capturing:
            self.capture.stop()
            self._capturing = False

    def set_quality(self, quality: str) -> None:
        self.quality = UpscalingQuality.parse(quality).value
        if hasattr(self.upscaler, "quality"):
            try:
                self.upscaler.quality = self.quality
            except AttributeError:
                pass

    # -- the one-shot path (lib.rs:944-976) --------------------------------

    def capture_and_upscale(
        self, input_width: int, input_height: int, output_width: int, output_height: int
    ) -> bytes:
        """Initialize (idempotent per size), grab the latest frame, upscale.
        Raises RuntimeError when no frame is available (the reference's
        anyhow!("No frame captured"))."""
        if (
            self.upscaler.input_width != input_width
            or self.upscaler.input_height != input_height
            or self.upscaler.output_width != output_width
            or self.upscaler.output_height != output_height
        ):
            self.upscaler.initialize(
                input_width, input_height, output_width, output_height
            )
        if not self._capturing:
            self.capture.start(self._capture_target)
            self._capturing = True
        # the producer thread may not have published yet right after start;
        # poll briefly (the reference errored immediately on its first-drain
        # None — an ergonomics fix, not a semantic change)
        got = None
        deadline = time.monotonic() + FIRST_FRAME_WAIT_S
        while got is None and time.monotonic() < deadline:
            got = self.capture.get_frame()
            if got is None:
                time.sleep(0.01)
        if got is None:
            raise RuntimeError("No frame captured")
        data, w, h = got
        if (w, h) != (input_width, input_height):
            raise RuntimeError(
                f"Captured frame is {w}x{h}, expected {input_width}x{input_height}"
            )
        return self.upscaler.upscale(data)

    def get_gpu_info(self):
        return self.gpu_info

    def get_upscaler_name(self) -> str:
        return self.upscaler.name

    def close(self) -> None:
        if self._capturing:
            self.capture.stop()
            self._capturing = False
