"""Capture classes of the port's API — the counterpart of
`nu_scaler_core/capture.py`: parity with `PyScreenCapture`,
`PyCaptureTarget`, `PyWindowByTitle`, `PyRegion` (lib.rs:168-325), over the
port's capture stack (`capture/screen.py`)."""

from __future__ import annotations

from typing import Optional, Tuple

from nu_scaler_tpu_torch.capture.screen import CaptureTarget, ScreenCapture as _ScreenCapture


class PyWindowByTitle:
    def __init__(self, title: str):
        self.title = title


class PyRegion:
    def __init__(self, x: int, y: int, width: int, height: int):
        self.x = x
        self.y = y
        self.width = width
        self.height = height


class _TargetKind:
    """One variant of the PyCaptureTarget enum (lib.rs:287-293)."""

    def __init__(self, name: str):
        self._name = name

    def __repr__(self) -> str:
        return f"PyCaptureTarget.{self._name}"

    def to_internal(
        self, window: Optional[PyWindowByTitle], region: Optional[PyRegion]
    ) -> CaptureTarget:
        """lib.rs:298-324: missing window → empty title; missing region →
        zero region."""
        if self._name == "FullScreen":
            return CaptureTarget.fullscreen()
        if self._name == "WindowByTitle":
            return CaptureTarget.window(window.title if window else "")
        r = region or PyRegion(0, 0, 0, 0)
        return CaptureTarget.region(r.x, r.y, r.width, r.height)


class PyCaptureTarget:
    """Enum-style class: PyCaptureTarget.FullScreen / .WindowByTitle / .Region."""

    FullScreen = _TargetKind("FullScreen")
    WindowByTitle = _TargetKind("WindowByTitle")
    Region = _TargetKind("Region")


class PyScreenCapture:
    """`PyScreenCapture` (lib.rs:209-281): start/stop/get_frame/list_windows."""

    def __init__(self):
        self._inner = _ScreenCapture()

    @staticmethod
    def list_windows() -> list[str]:
        return _ScreenCapture.list_windows()

    def start(
        self,
        target,
        window: Optional[PyWindowByTitle] = None,
        region: Optional[PyRegion] = None,
    ) -> None:
        tgt = target.to_internal(window, region)
        try:
            self._inner.start(tgt)
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(str(e)) from e

    def stop(self) -> None:
        self._inner.stop()

    def get_frame(self) -> Optional[Tuple[bytes, int, int]]:
        """Latest RGBA frame as (bytes, width, height), or None when no new
        frame is available (the reference's WouldBlock → None)."""
        return self._inner.get_frame()
