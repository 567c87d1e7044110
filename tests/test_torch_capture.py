"""The port's capture stack (nu_scaler_tpu_torch/capture: sources.py,
screen.py) against the JAX package's (`nu_scaler_tpu/capture`), on the CPU:
the same ring semantics, the same frames from the synthetic and file
sources, the same target dispatch. The sources are pure numpy on both sides,
so every frame is compared byte for byte."""

import time

import numpy as np
import pytest
from PIL import Image

from nu_scaler_tpu.capture import screen as jscreen
from nu_scaler_tpu.capture import sources as jsrc
from nu_scaler_tpu_torch import capture as pcap
from nu_scaler_tpu_torch.capture import screen as pscreen
from nu_scaler_tpu_torch.capture import sources as psrc
from nu_scaler_tpu_torch.capture.video import Y4MWriter


def test_capture_exports_equal_jax():
    import nu_scaler_tpu.capture as jcap

    assert pcap.__all__ == jcap.__all__
    for name in pcap.__all__:
        assert getattr(pcap, name).__name__ == getattr(jcap, name).__name__


@pytest.mark.parametrize("capacity", [1, 3, 5])
def test_frame_ring_equals_jax(capacity):
    """The same pushes and drains: the same latest frames, pushed and
    dropped counts (capacity 5 is the default)."""
    port, jax_side = psrc.FrameRing(capacity), jsrc.FrameRing(capacity)
    assert psrc.FrameRing()._dq.maxlen == jsrc.FrameRing()._dq.maxlen == 5
    for step, n in enumerate((0, 1, 2, 7, 3, 0, 6)):
        for i in range(n):
            frame = (bytes([step, i]) * 2, 1, 1)
            port.push(frame)
            jax_side.push(frame)
        assert len(port) == len(jax_side)
        assert port.latest() == jax_side.latest()
        assert (port.frames_pushed, port.frames_dropped) == (jax_side.frames_pushed, jax_side.frames_dropped)


@pytest.mark.parametrize("size", [(64, 48), (1280, 720), (37, 101)])
def test_synthetic_source_equals_jax(size):
    """12 ticks of the benchmark gradient and its moving square, frame for
    frame, including the square's wrap at the right edge."""
    w, h = size
    port, jax_side = psrc.SyntheticSource(w, h), jsrc.SyntheticSource(w, h)
    assert (port.width, port.height) == (jax_side.width, jax_side.height) == (w, h)
    port._t = jax_side._t = max(0, (w - 8) // 4 - 6)  # cross the wrap within 12 ticks
    for _ in range(12):
        a, b = port.next_frame(), jax_side.next_frame()
        assert a.shape == (h, w, 4) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["directory", "single"])
def test_file_source_equals_jax(tmp_path, rng, layout):
    frames = [rng.integers(0, 256, (12, 20, 4), np.uint8) for _ in range(3)]
    for i, f in enumerate(frames):
        Image.fromarray(f, "RGBA").save(tmp_path / f"frame_{i}.png")
    (tmp_path / "notes.txt").write_text("not a frame")
    path = str(tmp_path if layout == "directory" else tmp_path / "frame_1.png")
    port, jax_side = psrc.FileSource(path), jsrc.FileSource(path)
    assert (port.width, port.height) == (jax_side.width, jax_side.height) == (20, 12)
    for i in range(7):
        got = port.next_frame()
        np.testing.assert_array_equal(got, jax_side.next_frame())
        np.testing.assert_array_equal(got, frames[i % 3] if layout == "directory" else frames[1])


def test_file_source_refuses_an_empty_directory(tmp_path):
    with pytest.raises(ValueError, match="no image frames"):
        psrc.FileSource(str(tmp_path))


@pytest.mark.parametrize("region", [(0, 0, 32, 16), (40, 10, 100, 100), (-5, 3, 20, 20)])
def test_region_crop_equals_jax(region):
    """The crop of a synthetic source, clipped at its edges as JAX clips."""
    port = pscreen._RegionSource(psrc.SyntheticSource(64, 48), *region)
    jax_side = jscreen._RegionSource(jsrc.SyntheticSource(64, 48), *region)
    assert (port.x, port.y, port.width, port.height) == (jax_side.x, jax_side.y, jax_side.width,
                                                         jax_side.height)
    for _ in range(3):
        np.testing.assert_array_equal(port.next_frame(), jax_side.next_frame())
    with pytest.raises(ValueError, match="empty capture region"):
        pscreen._RegionSource(psrc.SyntheticSource(64, 48), 70, 0, 8, 8)


def _first_frame(cap, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cap.get_frame()
        if got is not None:
            return got
        time.sleep(0.01)
    raise AssertionError("no frame captured")


def _clip(path, frames):
    w = Y4MWriter(str(path), frames[0].shape[1], frames[0].shape[0], fps=30)
    for f in frames:
        w.write(f)
    w.close()


def test_screen_capture_targets(tmp_path, rng, monkeypatch):
    """The target dispatch of `ScreenCapture._make_source`, as JAX's: the
    synthetic 1280×720 window, a `video:` clip and a `file:` still; each
    delivered frame is one of its source's frames."""
    monkeypatch.delenv("DISPLAY", raising=False)
    clip = [rng.integers(0, 256, (16, 24, 4), np.uint8) for _ in range(3)]
    _clip(tmp_path / "clip.y4m", clip)
    still = rng.integers(0, 256, (10, 14, 4), np.uint8)
    Image.fromarray(still, "RGBA").save(tmp_path / "still.png")
    targets = {
        "Synthetic window": (1280, 720),
        f"video:{tmp_path / 'clip.y4m'}": (24, 16),
        f"file:{tmp_path / 'still.png'}": (14, 10),
    }
    for title, size in targets.items():
        target = pscreen.CaptureTarget.window(title)
        port_src = pscreen.ScreenCapture()._make_source(target)
        jax_src = jscreen.ScreenCapture()._make_source(jscreen.CaptureTarget.window(title))
        assert type(port_src).__name__ == type(jax_src).__name__
        expected = [jax_src.next_frame() for _ in range(3)]
        cap = pscreen.ScreenCapture(fps=200)
        cap.start(target)
        try:
            assert cap.is_capturing and cap.target == target
            data, w, h = _first_frame(cap)
        finally:
            cap.stop()
        assert (w, h) == size and not cap.is_capturing and cap.get_frame() is None
        frame = np.frombuffer(data, np.uint8).reshape(h, w, 4)
        if title.startswith("video:"):  # C420 in the file: the reader's frames
            assert any(np.array_equal(frame, e) for e in expected)
        elif title.startswith("file:"):
            np.testing.assert_array_equal(frame, still)
        else:  # the synthetic scene at some tick: its gradient outside the square
            np.testing.assert_array_equal(frame[:40], expected[0][:40])


def test_fullscreen_and_region_without_display(monkeypatch):
    """No DISPLAY: the synthetic desktop is the only window, X11Source
    raises, FullScreen is the synthetic 1920×1080 scene and a Region its
    crop."""
    monkeypatch.delenv("DISPLAY", raising=False)
    assert psrc.list_windows() == jsrc.list_windows() == ["Synthetic Desktop"]
    assert pscreen.ScreenCapture.list_windows() == ["Synthetic Desktop"]
    with pytest.raises(RuntimeError, match="no X11 display"):
        psrc.X11Source()
    cap = pscreen.ScreenCapture()
    full = cap._make_source(pscreen.CaptureTarget.fullscreen())
    assert isinstance(full, psrc.SyntheticSource) and (full.width, full.height) == (1920, 1080)
    region = cap._make_source(pscreen.CaptureTarget.region(100, 50, 64, 32))
    assert isinstance(region, pscreen._RegionSource) and (region.width, region.height) == (64, 32)
    np.testing.assert_array_equal(region.next_frame(), psrc.SyntheticSource().next_frame()[50:82, 100:164])
    with pytest.raises(ValueError, match="unknown capture target"):
        cap._make_source(pscreen.CaptureTarget("Monitor"))


class _Failing(psrc.FrameSource):
    width, height = 4, 4

    def __init__(self, fail_first: int) -> None:
        self.calls = 0
        self.fail_first = fail_first
        self.closed = False

    def next_frame(self):
        self.calls += 1
        if self.calls <= self.fail_first:
            raise OSError(f"grab {self.calls} failed")
        return np.zeros((4, 4, 4), np.uint8)

    def close(self):
        self.closed = True


@pytest.mark.parametrize("fail_first", [9, 10])
def test_producer_stops_after_ten_errors(fail_first):
    """Ten errors in a row end the capture thread (lib.rs:163-176); nine do
    not, and the next frame resets the run."""
    src, ring = _Failing(fail_first), psrc.FrameRing()
    producer = psrc.ProducerThread(src, ring, fps=0)
    producer.start()
    thread = producer._thread
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (ring.frames_pushed == 0 and thread.is_alive()):
        time.sleep(0.005)
    producer.stop()
    assert not thread.is_alive() and src.closed
    assert isinstance(producer.error, OSError)
    if fail_first >= 10:
        assert src.calls == 10 and ring.frames_pushed == 0
    else:
        assert ring.frames_pushed >= 1


def test_screen_capture_counts_drops(monkeypatch):
    """The producer outruns a consumer that never drains: the ring drops the
    oldest frames and `frames_dropped` reads the ring's count."""
    monkeypatch.setattr(pscreen.ScreenCapture, "_new_ring", staticmethod(lambda: psrc.FrameRing()))
    cap = pscreen.ScreenCapture(fps=0)
    cap.start(pscreen.CaptureTarget.region(0, 0, 16, 8))
    try:
        deadline = time.monotonic() + 10
        while cap.frames_dropped == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cap.frames_dropped > 0
        data, w, h = _first_frame(cap)
        assert (w, h) == (16, 8) and len(data) == 16 * 8 * 4
    finally:
        cap.stop()
