"""The traffic generator: input frames from a mix's parameters and `--seed`.

A clip of `clip_frames` distinct frames is made once in set-up and cycled, in
pageable host memory as a capture or a decoder hands it over. Each frame is
the harness pattern (`generate_test_pattern`, below) plus a seeded texture
(blocks with sharp edges and fine noise), moved by a seeded shift from the
frame before, so that neighbouring frames differ as a video's do. Every seed
gives the same sizes and the same amount of work; only the content changes.
"""

from __future__ import annotations

import numpy as np


def generate_test_pattern(width: int, height: int) -> np.ndarray:
    """Gradient pattern (a frozen copy of `bench/harness.generate_test_pattern`,
    the reference benchmark's integer math)."""
    x = np.arange(width, dtype=np.uint64)
    y = np.arange(height, dtype=np.uint64)
    img = np.empty((height, width, 4), dtype=np.uint8)
    img[..., 0] = (x * 255 // width).astype(np.uint8)[None, :]
    img[..., 1] = (y * 255 // height).astype(np.uint8)[:, None]
    img[..., 2] = ((x[None, :] + y[:, None]) * 255 // (width + height)).astype(np.uint8)
    img[..., 3] = 255
    return img


def make_clip(mix: dict, height: int, width: int, seed: int) -> list[np.ndarray]:
    """`mix["clip_frames"]` RGBA u8 frames [height, width, 4]."""
    rng = np.random.default_rng(seed)
    n, shift = int(mix["clip_frames"]), int(mix["shift_px_max"])
    cell, amp, noise = int(mix["texture_cell_px"]), int(mix["texture_amplitude"]), int(mix["noise_amplitude"])
    th, tw = height + 2 * shift * n, width + 2 * shift * n
    blocks = rng.integers(-amp, amp + 1, size=(-(-th // cell), -(-tw // cell), 3), dtype=np.int16)
    texture = np.repeat(np.repeat(blocks, cell, axis=0), cell, axis=1)[:th, :tw]
    texture = texture + rng.integers(-noise, noise + 1, size=(th, tw, 3), dtype=np.int16)
    base = generate_test_pattern(width, height).astype(np.int16)
    steps = rng.integers(-shift, shift + 1, size=(n, 2))
    steps[0] = 0
    oy, ox = shift * n, shift * n
    clip = []
    for dy, dx in steps:
        oy, ox = oy + int(dy), ox + int(dx)
        f = base.copy()
        f[..., :3] += texture[oy:oy + height, ox:ox + width]
        clip.append(np.clip(f, 0, 255).astype(np.uint8))
    return clip
