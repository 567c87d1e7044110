"""The port's two-launch resample (`kernels/resample_cuda.py` `resample_twopass`,
`ops/resample.py` `make_twopass_resampler`) against the JAX package's Pallas
`make_pallas_resampler` (interpret mode on the CPU) and the port's fused
resampler, on the CPU: the wrapper runs its plain version."""

import numpy as np
import pytest
import torch

from nu_scaler_tpu.kernels.resample_pallas import make_pallas_resampler
from nu_scaler_tpu_torch.kernels import resample_cuda as rc
from nu_scaler_tpu_torch.ops import resample

IN_H, IN_W, OUT_H, OUT_W = 128, 256, 256, 512  # the JAX test's sizes


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


@pytest.mark.parametrize("algo", ["lanczos3", "bilinear", "nearest"])
def test_matches_pallas_twocall(rng, algo):
    """≥ 60 dB (the JAX test's bound against XLA) and ≤ 1 LSB against the
    Pallas two-call kernel; nearest bit-exact. The Pallas kernel works in
    the /255 domain and packs trunc(clip(·, 0, 1)·255); the port sums raw
    0..255 samples, so a value on a packing edge may land one LSB apart.
    Measured on this seed: lanczos3 and nearest equal, bilinear 127 of
    524,288 bytes one LSB apart (84.3 dB)."""
    img = rng.integers(0, 256, (IN_H, IN_W, 4), np.uint8)
    fn = make_pallas_resampler(IN_H, IN_W, OUT_H, OUT_W, algo)
    assert fn is not None
    want = np.asarray(fn(img))
    got = resample.make_twopass_resampler(IN_H, IN_W, OUT_H, OUT_W, algo, "cpu")(img).numpy()
    assert got.shape == want.shape == (OUT_H, OUT_W, 4) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    if algo == "nearest":
        assert np.array_equal(got, want)
    assert d.max() <= 1
    assert psnr(got, want) >= 60.0


@pytest.mark.parametrize("algo", ["lanczos3", "bilinear", "nearest", "bicubic", "area"])
def test_equals_the_fused_resampler(rng, algo):
    """Bit for bit the port's `make_resampler`, also at non-integer ratios,
    which the Pallas banded form does not take."""
    for ih, iw, oh, ow in ((IN_H, IN_W, OUT_H, OUT_W), (64, 96, 48, 72), (64, 96, 30, 40)):
        img = rng.integers(0, 256, (ih, iw, 4), np.uint8)
        got = resample.make_twopass_resampler(ih, iw, oh, ow, algo, "cpu")(img)
        assert torch.equal(got, resample.make_resampler(ih, iw, oh, ow, algo, "cpu")(img))


def test_batch_equals_frames(rng):
    frames = rng.integers(0, 256, (3, 24, 40, 4), np.uint8)
    up = resample.make_twopass_resampler(24, 40, 48, 80, "lanczos3", "cpu")
    batch = up(frames)
    assert batch.shape == (3, 48, 80, 4)
    for i in range(3):
        assert torch.equal(batch[i], up(frames[i]))


def test_wrapper_checks_and_counts(rng):
    up = resample.make_twopass_resampler(8, 8, 16, 16, "bilinear", "cpu")
    assert isinstance(up, resample.Resampler) and up.algorithm == "bilinear"
    rc.reset_launches()
    up(rng.integers(0, 256, (8, 8, 4), np.uint8))
    assert rc.launches["resample_twopass"] == 0
    with pytest.raises(ValueError, match=r"expected shape \(8, 8, 4\)"):
        rc.resample_twopass(torch.zeros((8, 9, 4), dtype=torch.uint8), up.plan)
    with pytest.raises(TypeError, match="uint8"):
        rc.resample_twopass(torch.zeros((8, 8, 4)), up.plan)
    with pytest.raises(ValueError, match=r"expected \[H, W, 4\]"):
        up(torch.zeros((8, 8), dtype=torch.uint8))
    src = torch.zeros((1, 8, 8, 4), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        rc._launch_vert(src, 1, up.plan)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        rc._launch_horiz(torch.zeros((1, 16, 8, 4)), 1, up.plan)
