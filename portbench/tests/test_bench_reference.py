"""The plain references at a tiny size against the frozen goldens, and what
they (and the harness) may import."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import frames, registry
from portbench.guard import forbidden_loaded
from portbench.reference import esrgan_int8, lanczos, yuv420

HERE = Path(__file__).resolve().parents[1]


# -- a frozen copy of the repo's float64 golden (`kernels/reference.py`:
# `filter_weights` for lanczos3, `separable_resample_ref`), dense matrices


def golden_weights(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    r = 3.0 * fscale
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(centers - r).astype(np.int64) + 1
    ntaps = int(np.ceil(2 * r)) + 1
    taps = lo[:, None] + np.arange(ntaps)[None, :]
    x = (taps - centers[:, None]) / fscale
    w = np.where(np.abs(x) < 3, np.sinc(x) * np.sinc(x / 3), 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), ntaps), np.clip(taps, 0, in_size - 1).ravel()), w.ravel())
    return mat.astype(np.float32)


def golden_lanczos3(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    wv = golden_weights(img.shape[0], out_h).astype(np.float64)
    wh = golden_weights(img.shape[1], out_w).astype(np.float64)
    f = (img.astype(np.float32) / 255.0).astype(np.float64)
    h, w, c = f.shape
    tmp = (wv @ f.reshape(h, w * c)).reshape(out_h, w, c)
    out = np.tensordot(tmp, wh, axes=([1], [1])).transpose(0, 2, 1)
    out = np.ascontiguousarray(out).astype(np.float32)
    return np.trunc(np.clip(out, 0.0, 1.0) * 255.0).astype(np.uint8)


MIX = {"clip_frames": 3, "shift_px_max": 4, "texture_cell_px": 8, "texture_amplitude": 40,
       "noise_amplitude": 6}


def clip(h=48, w=80, seed=3):
    return frames.make_clip(MIX, h, w, seed)


def test_clip_is_seeded_and_moves():
    a, b = clip(seed=2**31 + 3), clip(seed=2**31 + 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], clip(seed=4)[0])
    assert not np.array_equal(a[0], a[1])
    assert all(f.shape == (48, 80, 4) and f.dtype == np.uint8 and (f[..., 3] == 255).all() for f in a)
    base = frames.generate_test_pattern(80, 48)
    assert base[0, 79, 0] == 79 * 255 // 80 and base[47, 0, 1] == 47 * 255 // 48


@pytest.mark.parametrize("shape", [(48, 80, 96, 160), (48, 80, 144, 240), (96, 160, 48, 80)])
def test_lanczos3_against_the_golden(shape):
    h, w, oh, ow = shape
    img = clip(h, w)[1]
    ref = lanczos.Lanczos3(h, w, oh, ow, torch.device("cpu"))(torch.from_numpy(img)).numpy()
    want = golden_lanczos3(img, oh, ow)
    d = np.abs(ref.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() > 0.999  # float64 sums in another order: trunc ties


def test_mix_rounds_half_to_even():
    a = torch.tensor([0, 1, 2, 3, 250], dtype=torch.uint8)
    b = torch.tensor([1, 2, 3, 4, 255], dtype=torch.uint8)
    assert lanczos.mix(a, b, 0.5).tolist() == [0, 2, 2, 4, 252]


def test_yuv420_against_the_golden():
    img = clip(48, 80)[0]
    planes = yuv420.rgba_to_yuv420_np(img)
    t = [torch.from_numpy(p) for p in planes]
    got = yuv420.rgba_to_yuv420(torch.from_numpy(img))
    for g, want in zip(got, planes):
        d = np.abs(g.numpy().astype(int) - want.astype(int))
        assert d.max() <= 1 and (d == 0).mean() > 0.99  # the 2x2 mean's order of sums
    back = yuv420.yuv420_to_rgba(*t).numpy()
    assert np.array_equal(back, yuv420.yuv420_to_rgba_np(*planes))


def test_esrgan_int8_reference_equals_the_program_on_the_cpu():
    """At 64x128 the program's int8 graph (its plain versions on the CPU) and
    the reference agree byte for byte; the int4 control does not."""
    from nu_scaler_tpu_torch.core.technologies import create_upscaler

    cfg = {**registry.config("esrgan_tpu4b2_x2_int8"), "in_h": 64, "in_w": 128, "out_h": 128, "out_w": 256}
    img = torch.from_numpy(clip(64, 128)[2])
    up = create_upscaler("dlss", "quality", device="cpu")
    up.initialize(128, 64, 256, 128)
    program = up.upscale_arr(img).numpy()
    ref = esrgan_int8.Reference(cfg, torch.device("cpu")).upscale(img).numpy()
    assert np.array_equal(program, ref)
    control = esrgan_int8.Reference(cfg, torch.device("cpu"), control=True).upscale(img).numpy()
    assert np.abs(control.astype(int) - ref.astype(int)).max() > 20


def test_reference_checks_the_checkpoint():
    cfg = {**registry.config("esrgan_tpu4b2_x2_int8"), "sha256": "0" * 64}
    with pytest.raises(ValueError):
        esrgan_int8.Reference(cfg, torch.device("cpu"))


def imports_of(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imports_of(path) & {"nu_scaler_tpu_torch", "nu_scaler_tpu", "jax", "jaxlib", "flax", "orbax"}


def test_harness_imports_no_jax():
    for path in HERE.rglob("*.py"):
        assert not imports_of(path) & {"nu_scaler_tpu", "jax", "jaxlib", "flax", "orbax"}, path


def test_import_guard_compares_top_level_names_whole():
    assert forbidden_loaded(["nu_scaler_tpu_torch", "nu_scaler_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert forbidden_loaded(["jax.numpy", "nu_scaler_tpu.ops", "orbax"]) == ["jax", "nu_scaler_tpu", "orbax"]
