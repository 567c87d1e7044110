"""Frame sources + ring buffer of the port: the counterpart of
`nu_scaler_tpu/capture/sources.py`, pure numpy and threads.

The reference pipeline (realtime.rs:282-382,564-657) is:

    capture thread (WGC, highest priority) → crossbeam channel → worker thread
    → mpsc → Python consumer draining to the *latest* frame.

Here that collapses to: producer thread → `FrameRing` (bounded, drop-oldest)
→ consumer calling `get_frame()` which drains to latest. The ring is backed by
the native C++ runtime when built (`nu_scaler_tpu_torch/runtime/native`), with
a pure-Python fallback.

Frames are RGBA bytes + (width, height) — the byte contract of
`PyScreenCapture.get_frame` (lib.rs:240-280).
"""

from __future__ import annotations

import abc
import os
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np

FramePacket = Tuple[bytes, int, int]  # (rgba_bytes, width, height)


class FrameRing:
    """Bounded drop-oldest frame ring with latest-drain semantics.

    Capacity 5 follows the legacy `FrameBuffer`
    (Nu_scale/src/capture/frame_buffer.rs:11-118).
    """

    def __init__(self, capacity: int = 5) -> None:
        self._dq: deque[FramePacket] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.frames_pushed = 0
        self.frames_dropped = 0

    def push(self, frame: FramePacket) -> None:
        with self._lock:
            if len(self._dq) == self._dq.maxlen:
                self.frames_dropped += 1
            self._dq.append(frame)
            self.frames_pushed += 1

    def latest(self) -> Optional[FramePacket]:
        """Drain the ring, returning only the newest frame (the consumer-side
        drain loop of realtime.rs:496-530)."""
        with self._lock:
            if not self._dq:
                return None
            frame = self._dq[-1]
            self._dq.clear()
            return frame

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


class FrameSource(abc.ABC):
    """A producer of RGBA frames at a nominal size."""

    width: int
    height: int

    @abc.abstractmethod
    def next_frame(self) -> np.ndarray:
        """Return the next frame as uint8 [H, W, 4] RGBA."""

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


class SyntheticSource(FrameSource):
    """Animated test scene: the benchmark gradient (benchmark.rs:188-207)
    plus a moving square so optical flow has real motion to find."""

    def __init__(self, width: int = 1920, height: int = 1080, speed: float = 4.0) -> None:
        self.width = width
        self.height = height
        self.speed = speed
        self._t = 0
        x = np.arange(width, dtype=np.uint64)
        y = np.arange(height, dtype=np.uint64)
        base = np.empty((height, width, 4), dtype=np.uint8)
        base[..., 0] = (x * 255 // width).astype(np.uint8)[None, :]
        base[..., 1] = (y * 255 // height).astype(np.uint8)[:, None]
        base[..., 2] = ((x[None, :] + y[:, None]) * 255 // (width + height)).astype(np.uint8)
        base[..., 3] = 255
        self._base = base

    def next_frame(self) -> np.ndarray:
        frame = self._base.copy()
        size = max(8, min(self.width, self.height) // 8)
        px = int(self._t * self.speed) % max(1, self.width - size)
        py = (self.height - size) // 2
        frame[py : py + size, px : px + size, :3] = 255
        self._t += 1
        return frame


class FileSource(FrameSource):
    """Cycles through PNG/JPG frames of a directory, or repeats one image."""

    def __init__(self, path: str) -> None:
        from PIL import Image

        if os.path.isdir(path):
            names = sorted(
                n for n in os.listdir(path) if n.lower().endswith((".png", ".jpg", ".jpeg"))
            )
            if not names:
                raise ValueError(f"no image frames in {path}")
            self._paths = [os.path.join(path, n) for n in names]
        else:
            self._paths = [path]
        self._Image = Image
        self._idx = 0
        first = self._load(0)
        self.height, self.width = first.shape[:2]
        self._cache = {0: first} if len(self._paths) == 1 else {}

    def _load(self, i: int) -> np.ndarray:
        img = self._Image.open(self._paths[i]).convert("RGBA")
        return np.asarray(img, dtype=np.uint8)

    def next_frame(self) -> np.ndarray:
        i = self._idx % len(self._paths)
        self._idx += 1
        if i in self._cache:
            return self._cache[i]
        return self._load(i)


class X11Source(FrameSource):
    """Live X11 screen grab via `mss` when a display exists; raises
    RuntimeError otherwise (callers fall back to SyntheticSource)."""

    def __init__(self) -> None:
        if not os.environ.get("DISPLAY"):
            raise RuntimeError("no X11 display")
        try:
            import mss  # type: ignore
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("mss not installed") from e
        self._sct = mss.mss()
        mon = self._sct.monitors[1]
        self.width = mon["width"]
        self.height = mon["height"]
        self._mon = mon

    def next_frame(self) -> np.ndarray:  # pragma: no cover - needs display
        shot = self._sct.grab(self._mon)
        bgra = np.frombuffer(shot.raw, dtype=np.uint8).reshape(shot.height, shot.width, 4)
        rgba = bgra[..., [2, 1, 0, 3]].copy()  # BGRA→RGBA (lib.rs:253-261)
        return rgba

    def close(self) -> None:  # pragma: no cover
        self._sct.close()


class ProducerThread:
    """The capture-thread role: pulls frames from a source at `fps` into a
    ring until stopped (realtime.rs:312-334's dedicated thread)."""

    def __init__(self, source: FrameSource, ring: FrameRing, fps: float = 60.0) -> None:
        self.source = source
        self.ring = ring
        self.fps = fps
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="nu-capture", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        interval = 1.0 / self.fps if self.fps > 0 else 0.0
        consecutive_errors = 0
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                frame = self.source.next_frame()
                self.ring.push((frame.tobytes(), frame.shape[1], frame.shape[0]))
                consecutive_errors = 0
            except Exception as e:  # noqa: BLE001 — a capture thread that must keep running
                consecutive_errors += 1
                self.error = e
                # abort after 10 consecutive errors (Nu_scale/src/lib.rs:163-176)
                if consecutive_errors >= 10:
                    break
            dt = time.monotonic() - t0
            if interval > dt:
                self._stop.wait(interval - dt)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.source.close()


def list_windows() -> list[str]:
    """`ScreenCapture::list_windows` parity (Win32 EnumWindows in the
    reference). On X11, enumerate via xlib when available; otherwise the
    synthetic desktop."""
    if os.environ.get("DISPLAY"):
        try:  # pragma: no cover - needs display
            from Xlib import display  # type: ignore

            d = display.Display()
            root = d.screen().root
            ids = root.get_full_property(
                d.intern_atom("_NET_CLIENT_LIST"), 0
            )
            names = []
            for wid in ids.value:
                w = d.create_resource_object("window", wid)
                name = w.get_wm_name()
                if name:
                    names.append(str(name))
            return names
        except Exception:
            pass
    return ["Synthetic Desktop"]
