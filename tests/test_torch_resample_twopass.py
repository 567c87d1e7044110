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


# the two-call resample's launch shapes on the card (chip_smoke.py phase 3)
LAUNCH_SHAPES = [((1080, 1920), (2160, 3840), "lanczos3"), ((1080, 1920), (2160, 3840), "bilinear"),
                 ((1080, 1920), (2160, 3840), "nearest"), ((2160, 3840), (1080, 1920), "lanczos3"),
                 ((768, 1366), (1080, 1920), "lanczos3"), ((768, 1366), (1080, 1920), "bilinear"),
                 ((384, 683), (768, 1366), "bilinear"), ((2048, 2048), (128, 128), "lanczos3")]


def _fma32(a, b, c):
    """An fp32 multiply-add as numpy can form it (the product exact in
    float64, one float64 sum, one rounding to fp32): a stand-in for fmaf
    that, like it, leaves a sum unchanged when it adds 0 · x."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


@pytest.mark.parametrize("in_hw, out_hw, algo", LAUNCH_SHAPES)
def test_twopass_bands_at_launch_shapes(rng, in_hw, out_hw, algo):
    """Each axis's dense bands (runs of 8 rows, groups of 4 columns) hold
    exactly the compact taps: the dense matrix they rebuild is the taps'
    own, every window row or column past the axis has zero weight (the
    kernel reads it at the last one), and the dense fmaf chain of every
    output, window by window from +0, gives the bits of the compact chain
    of its own taps."""
    from nu_scaler_tpu_torch.kernels import reference as ref

    for axis, run in ((0, rc.RUN), (1, rc.GROUP)):
        n_in, n_out = in_hw[axis], out_hw[axis]
        first, taps = rc.taps_from_matrix(ref.filter_weights(n_in, n_out, algo))
        bands, window = rc.twopass_bands(first, taps, run)
        runs = -(-n_out // run)
        assert bands.shape == (runs, window, run) and bands.dtype == np.float32
        assert window == rc.footprint(first, taps.shape[1], run)
        start = first[::run]
        cols = start[:, None] + np.arange(window)[None, :]  # [runs, window]
        assert np.all(bands[cols >= n_in] == 0)
        o = np.arange(runs)[:, None, None] * run + np.arange(run)[None, None, :]
        dense = np.zeros((runs * run, n_in + window), np.float32)
        np.add.at(dense, (np.broadcast_to(o, bands.shape), np.broadcast_to(cols[..., None], bands.shape)),
                  bands)
        assert np.all(dense[n_out:] == 0) and np.all(dense[:, n_in:] == 0)
        assert np.array_equal(dense[:n_out, :n_in], rc.dense_from_taps(first, taps, n_in))

        x = rng.integers(0, 256, (n_in, 16)).astype(np.float32)
        compact = np.zeros((n_out, 16), np.float32)
        for k in range(taps.shape[1]):
            compact = _fma32(taps[:, k, None], x[first + k], compact)
        chain = np.zeros((runs, run, 16), np.float32)
        for j in range(window):
            xj = x[np.minimum(start + j, n_in - 1)]
            chain = _fma32(bands[:, j, :, None], xj[:, None, :], chain)
        assert np.array_equal(chain.reshape(-1, 16)[:n_out].view(np.int32), compact.view(np.int32))


def test_plan_holds_the_twopass_bands():
    """The plan's bands on its device: the vertical ones as built, the
    horizontal ones [wh, groups, 4] (a float4 per group, neighbouring groups
    side by side)."""
    plan = resample.make_resampler(1080, 1920, 2160, 3840, "lanczos3", "cpu").plan
    tp = plan.twopass
    first_v, taps_v, first_h, taps_h = plan._np
    dv, wv = rc.twopass_bands(first_v, taps_v, rc.RUN)
    dh, wh = rc.twopass_bands(first_h, taps_h, rc.GROUP)
    assert (tp.wv, tp.wh) == (wv, wh) == (10, 8)
    assert tp.dv.dtype == tp.dh.dtype == torch.float32 and tp.dv.is_contiguous() and tp.dh.is_contiguous()
    assert np.array_equal(tp.dv.numpy(), dv)
    assert tuple(tp.dh.shape) == (wh, 3840 // 4, 4)
    assert np.array_equal(tp.dh.numpy(), dh.transpose(1, 0, 2))
