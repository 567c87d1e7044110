"""The port's native runtime (host C++ built by g++: runtime/native/
framering.cpp and y4m.cpp, bound by runtime/framering.py and
capture/video.py) against the JAX package's (`nu_scaler_tpu/runtime/
framering.py`, `nu_scaler_tpu/capture/video.py`), on the CPU. The libraries
build at their first use into build/nu_scaler_tpu_torch/ under a name keyed
by their source's hash; nothing is written into the JAX package. The ring
and the demuxer give the same frames and counts as JAX's, byte for byte;
the demuxer is within 1 LSB of the pure-Python reader (it converts in
float64 where numpy converts in float32)."""

import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

from nu_scaler_tpu.capture import video as jvideo
from nu_scaler_tpu.runtime import framering as jfr
from nu_scaler_tpu_torch.capture import screen as pscreen
from nu_scaler_tpu_torch.capture import sources as psrc
from nu_scaler_tpu_torch.capture import video as pvideo
from nu_scaler_tpu_torch.kernels import _build
from nu_scaler_tpu_torch.runtime import framering as pfr

JAX_PKG = Path(jfr.__file__).resolve().parents[1]


def _files(root: Path) -> set:
    return {p for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def jax_native():
    """JAX's native ring, or a skip where its own build fails (its tests
    skip the same way)."""
    if not jfr.native_available():
        pytest.skip("the JAX package's native ring did not build")
    return jfr


def _clip(path, frames, fps=30.0):
    w = pvideo.Y4MWriter(str(path), frames[0].shape[1], frames[0].shape[0], fps=fps)
    for f in frames:
        w.write(f)
    w.close()


def test_libraries_build_under_build_dir():
    """Both libraries build (or are reused) under build/nu_scaler_tpu_torch/,
    keyed by source and flags; no file appears in the JAX package."""
    before = _files(JAX_PKG)
    assert pfr.native_available() and pvideo.native_y4m_available()
    assert pfr.build_error is None and pvideo.y4m_build_error is None
    for name in ("framering", "y4m"):
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.is_file()
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
        assert _build.source_path(name) == Path(pfr.__file__).parent / "native" / f"{name}.cpp"
    assert "-march=native" not in _build.GXX_FLAGS and "-pthread" in _build.GXX_FLAGS
    assert _files(JAX_PKG) <= before


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the host library")
def test_build_cli_builds_the_host_library(monkeypatch, tmp_path, capsys):
    """`python -m nu_scaler_tpu_torch.kernels._build framering` (the host
    half; the CUDA half runs in chip_smoke.py): built once and its path
    printed, reused on a second call, rebuilt with --force; an unknown name
    is refused."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    path = _build.library_path("framering")
    assert path.parent == tmp_path and not path.exists()
    for argv, built in ((["framering"], True), (["framering"], False), (["--force", "framering"], True)):
        before = path.stat().st_mtime_ns if path.exists() else None
        assert _build.main(argv) == 0
        out = capsys.readouterr().out
        assert out.splitlines()[-1] == str(path) and path.is_file()
        assert (f"g++ built {path.name}" in out) == built
        assert (path.stat().st_mtime_ns != before) == built
    with pytest.raises(SystemExit):
        _build.main(["framering", "nope"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]


def test_host_library_key_follows_its_source(monkeypatch, tmp_path):
    """A changed C++ source changes its library's name and no other's."""
    before = {n: _build.library_path(n).name for n in ("framering", "y4m", "fsr")}
    native = tmp_path / "native"
    native.mkdir()
    for name in ("framering", "y4m"):
        (native / f"{name}.cpp").write_bytes(_build.source_path(name).read_bytes())
    monkeypatch.setattr(_build, "NATIVE", native)
    assert {n: _build.library_path(n).name for n in before} == before
    (native / "y4m.cpp").write_text((native / "y4m.cpp").read_text() + "\n// changed\n")
    after = {n: _build.library_path(n).name for n in before}
    assert after["y4m"] != before["y4m"] and after["framering"] == before["framering"]


def test_failed_build_is_recorded_and_capture_falls_back(monkeypatch, tmp_path):
    """Without g++ the ring is not available, the module holds why, and the
    capture stack serves the pure-Python ring (the JAX package's
    behaviour); the y4m factory serves the Python reader."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(pfr, "_lib", None)
    monkeypatch.setattr(pfr, "build_error", None)
    monkeypatch.setattr(pvideo, "_Y4M_LIB", None)
    monkeypatch.setattr(pvideo, "y4m_build_error", None)
    _build.load_library.cache_clear()
    try:
        assert not pfr.native_available()
        assert "g++ not found" in pfr.build_error
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            pfr.NativeFrameRing()
        assert isinstance(pscreen.ScreenCapture._new_ring(), psrc.FrameRing)
        bgra = np.arange(64, dtype=np.uint8).reshape(4, 4, 4)
        np.testing.assert_array_equal(pfr.bgra_to_rgba(bgra), bgra[..., [2, 1, 0, 3]])
        _clip(tmp_path / "c.y4m", [np.zeros((4, 6, 4), np.uint8)])
        assert isinstance(pvideo.open_reader(str(tmp_path / "c.y4m")), pvideo.Y4MReader)
        assert "g++ not found" in pvideo.y4m_build_error
    finally:
        _build.load_library.cache_clear()
    assert list(tmp_path.glob("*.so")) == []


def _pushes(rng):
    """Frames of several sizes, in bursts: (frame, drain after it)."""
    out = []
    for i in range(12):
        h, w = (8, 8) if i % 3 else (4, 6)
        out.append((rng.integers(0, 256, (h, w, 4), np.uint8), i % 4 == 3))
    return out


@pytest.mark.parametrize("capacity", [1, 3, 5])
def test_native_ring_equals_python_and_jax(rng, jax_native, capacity):
    """The same pushes (bytes and arrays) and drains give the same frames and
    counts on the port's native ring, the Python ring and JAX's native
    ring."""
    rings = (pfr.NativeFrameRing(capacity, 64 * 64 * 4), psrc.FrameRing(capacity),
             jax_native.NativeFrameRing(capacity, 64 * 64 * 4))
    assert rings[0].latest() is None
    for frame, drain in _pushes(rng):
        h, w = frame.shape[:2]
        for k, ring in enumerate(rings):
            if k == 1 or drain:
                ring.push((frame.tobytes(), w, h))
            else:
                ring.push_array(frame)
        if drain:
            got = [r.latest() for r in rings]
            assert got[0] == got[1] == got[2] and got[0][1:] == (w, h)
            assert all(r.latest() is None for r in rings)
        counts = [(r.frames_pushed, r.frames_dropped) for r in rings]
        assert counts[0] == counts[1] == counts[2]


def test_native_ring_truncates_to_none():
    """A frame larger than the ring's buffer drains as no frame."""
    ring = pfr.NativeFrameRing(2, max_frame_bytes=16)
    ring.push_array(np.zeros((4, 4, 4), np.uint8))
    assert ring.latest() is None and ring.frames_pushed == 1


def test_short_buffers_raise():
    """The C side copies w*h*4 bytes: a short buffer is refused in Python."""
    ring = pfr.NativeFrameRing(2, 1024)
    with pytest.raises(ValueError, match="frame buffer is 63 bytes, expected 64 for 4x4 RGBA"):
        ring.push((bytes(63), 4, 4))
    with pytest.raises(ValueError, match="frame array is 48 bytes, expected 64 for 4x4 RGBA"):
        ring.push_array(np.zeros((4, 4, 3), np.uint8))
    assert ring.frames_pushed == 0


def test_native_ring_threaded_hammer():
    """4 producers and a draining consumer on one native ring, with a short
    switch interval: every push counted, every drained frame whole."""
    import sys

    ring = pfr.NativeFrameRing(capacity=4, max_frame_bytes=64)
    errors, stop = [], threading.Event()
    interval = sys.getswitchinterval()

    def produce(tid):
        try:
            for i in range(300):
                ring.push((bytes([tid * 50 + i % 50]) * 64, 4, 4))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def consume():
        try:
            while not stop.is_set():
                got = ring.latest()
                if got is not None:
                    data, w, h = got
                    assert (w, h) == (4, 4) and len(set(data)) == 1
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    sys.setswitchinterval(1e-5)
    try:
        consumer = threading.Thread(target=consume)
        consumer.start()
        producers = [threading.Thread(target=produce, args=(t,)) for t in range(4)]
        for t in producers:
            t.start()
        for t in producers:
            t.join(timeout=30)
        stop.set()
        consumer.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in [*producers, consumer])
    assert not errors, errors
    assert ring.frames_pushed == 4 * 300


@pytest.mark.parametrize("shape", [(16, 16), (3, 37), (1, 1)])
def test_bgra_and_test_pattern_equal_jax(rng, jax_native, shape):
    bgra = rng.integers(0, 256, (*shape, 4), np.uint8)
    got = pfr.bgra_to_rgba(bgra)
    np.testing.assert_array_equal(got, bgra[..., [2, 1, 0, 3]])
    np.testing.assert_array_equal(got, jax_native.bgra_to_rgba(bgra))
    h, w = shape
    for tick in (0, 1, 7, 500):
        np.testing.assert_array_equal(pfr.native_test_pattern(w * 8, h * 8, tick),
                                      jax_native.native_test_pattern(w * 8, h * 8, tick))


@pytest.mark.parametrize("size", [(48, 32), (30, 18)])
def test_native_y4m_reader_equals_jax(tmp_path, rng, size):
    """≤ 1 LSB from the port's Y4MReader, byte-equal to JAX's native reader,
    frame for frame, again after `rewind`; the header's size and rate."""
    w, h = size
    frames = [rng.integers(0, 256, (h, w, 4), np.uint8) for _ in range(3)]
    path = tmp_path / "clip.y4m"
    _clip(path, frames, fps=24.0)
    python_frames = list(pvideo.Y4MReader(str(path)))
    jax_reader = jvideo.NativeY4MReader(str(path))
    reader = pvideo.NativeY4MReader(str(path))
    assert (reader.width, reader.height, reader.fps) == (w, h, 24.0)
    for _ in range(2):
        got = list(reader)
        assert len(got) == 3
        for g, p, j in zip(got, python_frames, jax_reader):
            np.testing.assert_array_equal(g, j)
            assert np.abs(g.astype(int) - p).max() <= 1
        reader.rewind()
        jax_reader.rewind()
    reader.close()
    reader.close()  # closing twice is harmless
    jax_reader.close()


def test_native_y4m_reader_refuses_bad_files(tmp_path):
    (tmp_path / "bad.y4m").write_bytes(b"NOTY4M W4 H4\n")
    (tmp_path / "c422.y4m").write_bytes(b"YUV4MPEG2 W4 H4 F30:1 C422\n")
    for name in ("bad.y4m", "c422.y4m", "missing.y4m"):
        with pytest.raises(ValueError, match="not a supported Y4M file"):
            pvideo.NativeY4MReader(str(tmp_path / name))
    (tmp_path / "broken.y4m").write_bytes(b"YUV4MPEG2 W4 H4 F30:1 C420\nFRAMX\n" + bytes(24))
    with pytest.raises(ValueError, match="corrupt Y4M stream"):
        next(pvideo.NativeY4MReader(str(tmp_path / "broken.y4m")))


def test_open_reader_dispatch(tmp_path, monkeypatch):
    path = tmp_path / "clip.y4m"
    _clip(path, [np.zeros((4, 6, 4), np.uint8)])
    assert isinstance(pvideo.open_reader(str(path)), pvideo.NativeY4MReader)
    assert isinstance(pvideo.open_reader(str(path), native="native"), pvideo.NativeY4MReader)
    assert isinstance(pvideo.open_reader(str(path), native="python"), pvideo.Y4MReader)
    monkeypatch.setattr(pvideo, "native_y4m_available", lambda: False)
    assert isinstance(pvideo.open_reader(str(path)), pvideo.Y4MReader)
    assert isinstance(pvideo.open_reader(str(path), native="native"), pvideo.NativeY4MReader)


def test_video_source_loops_as_jax(tmp_path, rng):
    frames = [rng.integers(0, 256, (8, 10, 4), np.uint8) for _ in range(3)]
    path = str(tmp_path / "clip.y4m")
    _clip(path, frames, fps=25.0)
    port, jax_side = pvideo.VideoSource(path), jvideo.VideoSource(path)
    assert (port.width, port.height, port.fps) == (jax_side.width, jax_side.height, jax_side.fps) == (10, 8, 25.0)
    got = [port.next_frame() for _ in range(7)]
    for g, j in zip(got, (jax_side.next_frame() for _ in range(7))):
        np.testing.assert_array_equal(g, j)
    np.testing.assert_array_equal(got[0], got[3])
    np.testing.assert_array_equal(got[1], got[4])
    port.close()
    jax_side.close()
