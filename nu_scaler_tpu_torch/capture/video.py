"""Dependency-free video I/O of the port: the copy of the numpy parts of
`nu_scaler_tpu/capture/video.py`. The BT.601 full-swing 4:2:0 goldens
(`_yuv420_to_rgba`, `_rgba_to_yuv420`), which `ops/color.py`'s converters
are held against, and a YUV4MPEG2 (C420) reader and writer:

    ffmpeg -i clip.mp4 -pix_fmt yuv420p clip.y4m
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def _yuv420_to_rgba(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BT.601 full-swing YUV420 → RGBA u8."""
    h, w = y.shape
    uf = u.repeat(2, axis=0).repeat(2, axis=1)[:h, :w].astype(np.float32) - 128.0
    vf = v.repeat(2, axis=0).repeat(2, axis=1)[:h, :w].astype(np.float32) - 128.0
    yf = y.astype(np.float32)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = np.clip(yf + 1.402 * vf, 0, 255)
    out[..., 1] = np.clip(yf - 0.344136 * uf - 0.714136 * vf, 0, 255)
    out[..., 2] = np.clip(yf + 1.772 * uf, 0, 255)
    out[..., 3] = 255
    return out


def _rgba_to_yuv420(rgba: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    r = rgba[..., 0].astype(np.float32)
    g = rgba[..., 1].astype(np.float32)
    b = rgba[..., 2].astype(np.float32)
    y = np.clip(0.299 * r + 0.587 * g + 0.114 * b, 0, 255).astype(np.uint8)
    u = np.clip(-0.168736 * r - 0.331264 * g + 0.5 * b + 128.0, 0, 255)
    v = np.clip(0.5 * r - 0.418688 * g - 0.081312 * b + 128.0, 0, 255)
    h2, w2 = (rgba.shape[0] // 2) * 2, (rgba.shape[1] // 2) * 2
    u420 = u[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3)).astype(np.uint8)
    v420 = v[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3)).astype(np.uint8)
    return y, u420, v420


class Y4MReader:
    """Iterates RGBA frames from a YUV4MPEG2 (C420) file."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        header = self._f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"not a Y4M file: {path}")
        self.width = self.height = 0
        self.fps = 30.0
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "F":
                num, den = tok[1:].split(":")
                self.fps = int(num) / int(den)
            elif tok[0] == "C" and not tok[1:].startswith("420"):
                raise ValueError(f"only C420 supported, got {tok}")
        if not (self.width and self.height):
            raise ValueError("Y4M header missing W/H")
        self._ysize = self.width * self.height
        self._csize = (self.width // 2) * (self.height // 2)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        marker = self._f.readline()
        if not marker:
            raise StopIteration
        if not marker.startswith(b"FRAME"):
            raise ValueError(f"bad frame marker {marker[:16]!r}")
        raw = self._f.read(self._ysize + 2 * self._csize)
        if len(raw) < self._ysize + 2 * self._csize:
            raise StopIteration
        y = np.frombuffer(raw, np.uint8, self._ysize).reshape(self.height, self.width)
        u = np.frombuffer(raw, np.uint8, self._csize, self._ysize).reshape(
            self.height // 2, self.width // 2
        )
        v = np.frombuffer(
            raw, np.uint8, self._csize, self._ysize + self._csize
        ).reshape(self.height // 2, self.width // 2)
        return _yuv420_to_rgba(y, u, v)

    def close(self) -> None:
        self._f.close()


class Y4MWriter:
    """Writes RGBA frames to a YUV4MPEG2 (C420) file."""

    def __init__(self, path: str, width: int, height: int, fps: float = 60.0):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")
        num = int(round(fps * 1000))
        self._f.write(
            f"YUV4MPEG2 W{width} H{height} F{num}:1000 Ip A1:1 C420jpeg\n".encode()
        )

    def write(self, rgba: np.ndarray) -> None:
        y, u, v = _rgba_to_yuv420(np.asarray(rgba, np.uint8))
        self._f.write(b"FRAME\n")
        self._f.write(y.tobytes())
        self._f.write(u.tobytes())
        self._f.write(v.tobytes())

    def close(self) -> None:
        self._f.close()
