"""ScreenCapture of the port — the counterpart of
`nu_scaler_tpu/capture/screen.py`: `RealTimeCapture` semantics
(realtime.rs:80-87,401-540).

Target selection mirrors `CaptureTarget` (realtime.rs:68-78):
  * FullScreen   → X11 grab if a display exists, else synthetic 1080p scene
  * WindowByTitle→ synthetic scene tagged with the title (no compositor here)
  * Region       → cropping wrapper over the FullScreen source (the reference
                   left Region unimplemented — realtime.rs:432; we implement it)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from nu_scaler_tpu_torch.capture import sources as _src


@dataclasses.dataclass
class CaptureTarget:
    kind: str  # "FullScreen" | "WindowByTitle" | "Region"
    title: str = ""
    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0

    @staticmethod
    def fullscreen() -> "CaptureTarget":
        return CaptureTarget("FullScreen")

    @staticmethod
    def window(title: str) -> "CaptureTarget":
        return CaptureTarget("WindowByTitle", title=title)

    @staticmethod
    def region(x: int, y: int, width: int, height: int) -> "CaptureTarget":
        return CaptureTarget("Region", x=x, y=y, width=width, height=height)


class _RegionSource(_src.FrameSource):
    def __init__(self, inner: _src.FrameSource, x: int, y: int, w: int, h: int) -> None:
        self.inner = inner
        self.x, self.y = max(0, x), max(0, y)
        self.width = min(w, inner.width - self.x)
        self.height = min(h, inner.height - self.y)
        if self.width <= 0 or self.height <= 0:
            raise ValueError("empty capture region")

    def next_frame(self) -> np.ndarray:
        f = self.inner.next_frame()
        return f[self.y : self.y + self.height, self.x : self.x + self.width]

    def close(self) -> None:
        self.inner.close()


class ScreenCapture:
    """start/stop/get_frame/list_windows parity with `ScreenCapture`
    (realtime.rs:162-540)."""

    def __init__(self, fps: float = 60.0) -> None:
        self.fps = fps
        self.target: Optional[CaptureTarget] = None
        self._ring = _src.FrameRing()
        self._producer: Optional[_src.ProducerThread] = None
        self.is_capturing = False

    # -- lifecycle --------------------------------------------------------

    def start(self, target: CaptureTarget) -> None:
        if self.is_capturing:
            self.stop()
        source = self._make_source(target)
        self.target = target
        self._ring = self._new_ring()
        self._producer = _src.ProducerThread(source, self._ring, fps=self.fps)
        self._producer.start()
        self.is_capturing = True

    @staticmethod
    def _new_ring():
        """Prefer the native C++ ring (GIL-light copies); the Python ring when
        it cannot be built (`runtime.framering.build_error` says why)."""
        from nu_scaler_tpu_torch.runtime.framering import NativeFrameRing, native_available

        if native_available():
            return NativeFrameRing(capacity=5)
        return _src.FrameRing()

    def _make_source(self, target: CaptureTarget) -> _src.FrameSource:
        def fullscreen() -> _src.FrameSource:
            try:
                return _src.X11Source()
            except RuntimeError:
                return _src.SyntheticSource()

        if target.kind == "FullScreen":
            return fullscreen()
        if target.kind == "WindowByTitle":
            # "window" sources beyond a compositor: video:<path.y4m> plays a
            # clip, file:<path|dir> cycles stills — otherwise a synthetic
            # window-sized scene (no compositor in this environment)
            if target.title.startswith("video:"):
                from nu_scaler_tpu_torch.capture.video import VideoSource

                return VideoSource(target.title[len("video:"):])
            if target.title.startswith("file:"):
                return _src.FileSource(target.title[len("file:"):])
            return _src.SyntheticSource(width=1280, height=720)
        if target.kind == "Region":
            return _RegionSource(fullscreen(), target.x, target.y, target.width, target.height)
        raise ValueError(f"unknown capture target {target.kind!r}")

    def stop(self) -> None:
        if self._producer is not None:
            self._producer.stop()
            self._producer = None
        self.is_capturing = False

    # -- frames -----------------------------------------------------------

    def get_frame(self) -> Optional[Tuple[bytes, int, int]]:
        """Latest frame or None ('WouldBlock' == no frame, realtime.rs:485)."""
        if not self.is_capturing:
            return None
        return self._ring.latest()

    @property
    def frames_dropped(self) -> int:
        return self._ring.frames_dropped

    @staticmethod
    def list_windows() -> list[str]:
        return _src.list_windows()
