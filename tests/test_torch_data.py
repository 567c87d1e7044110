"""The port's training and evaluation data (`nu_scaler_tpu_torch/models/data.py`,
`models/train.py` `make_batch`) against the JAX package's
(`nu_scaler_tpu/models/data.py`, `train.py`), on the CPU.

The clip renderer, the video-path round trip, the synthetic batches and the
crop pool are numpy on both sides: bit-equal for the same seed, and each
leaves its generator where JAX's leaves it. `eval_vs_lanczos3` with the same
fixed `apply_fn` on both sides: within 0.05 dB and 1e-3 SSIM (its lanczos3
reference is the port's resample against JAX's `make_resampler`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.models import data as jdata
from nu_scaler_tpu.models import train as jtrain
from nu_scaler_tpu_torch.models import data as pdata
from nu_scaler_tpu_torch.models import train as ptrain


@pytest.mark.parametrize("seed", [0, 901])
def test_render_clip_is_bit_equal(seed):
    got = pdata.render_clip(96, 160, frames=3, seed=seed)
    want = jdata.render_clip(96, 160, frames=3, seed=seed)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (96, 160, 4)
        np.testing.assert_array_equal(g, w)


def test_clip_through_video_path_is_bit_equal(tmp_path):
    frames = pdata.render_clip(96, 160, frames=3, seed=4)
    got = pdata.clip_through_video_path(frames)
    np.testing.assert_array_equal(np.stack(got), np.stack(jdata.clip_through_video_path(frames)))
    # 4:2:0 moves the bytes: the round trip is the video path, not a copy
    assert not np.array_equal(np.stack(got), np.stack(frames))
    path = tmp_path / "clip.y4m"
    np.testing.assert_array_equal(np.stack(pdata.clip_through_video_path(frames, str(path))), np.stack(got))
    assert path.exists()


@pytest.mark.parametrize("seed,scale", [(0, 2), (3, 4)])
def test_make_batch_is_bit_equal(seed, scale):
    rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    got = ptrain.make_batch(rp, 3, size=32, scale=scale)
    want = jtrain.make_batch(rj, 3, size=32, scale=scale)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert rp.integers(1 << 30) == rj.integers(1 << 30)


def test_pair_pool_is_bit_equal():
    """Two clips, one of them rendered at 2x and area-downsampled (down_mix
    0.5), 16 crops of 32 px at scale 2, then a batch draw."""
    rp, rj = np.random.default_rng(11), np.random.default_rng(11)
    got = pdata.PairPool(rp, scale=2, crop=32, n_clips=2, pool_size=16, down_mix=0.5)
    want = jdata.PairPool(rj, scale=2, crop=32, n_clips=2, pool_size=16, down_mix=0.5)
    assert got.hrs.shape == (16, 32, 32, 3) and got.lrs.shape == (16, 16, 16, 3)
    np.testing.assert_array_equal(got.hrs, want.hrs)
    np.testing.assert_array_equal(got.lrs, want.lrs)
    for g, w in zip(got.batch(rp, 4), want.batch(rj, 4)):
        np.testing.assert_array_equal(g, w)


def test_eval_vs_lanczos3_matches_jax():
    """The same fixed net on both sides (a 2x nearest repeat): the scores
    agree (measured: lanczos3 within 2e-6 dB and 2e-7 SSIM of JAX's), and
    lanczos3 keeps more structure (SSIM) than the repeat's blocks."""
    got = pdata.eval_vs_lanczos3(lambda x: x.repeat_interleave(2, 1).repeat_interleave(2, 2), device="cpu")
    want = jdata.eval_vs_lanczos3(lambda x: jnp.repeat(jnp.repeat(x, 2, 1), 2, 2))
    assert list(got) == list(want)
    print({k: (got[k], want[k]) for k in got})
    for k in ("net_psnr_db", "lanczos3_psnr_db", "psnr_delta_db"):
        assert abs(got[k] - want[k]) <= 0.05, k
    for k in ("net_ssim", "lanczos3_ssim", "ssim_delta"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    assert got["net_psnr_db"] == want["net_psnr_db"]  # the net's side is numpy on the same bytes
    assert got["ssim_delta"] < 0


def test_eval_interp_refinement_on_the_cpu():
    """The port's held-out refinement eval at a small frame (the committed
    interp_ref4 on flow_soft mids): both modes scored on the same truths."""
    out = pdata.eval_interp_refinement(seeds=(900,), frames=3, height=64, width=256, device="cpu")
    assert set(out) == {"soft_psnr_db", "soft_ssim", "ref_psnr_db", "ref_ssim", "psnr_delta_db", "ssim_delta"}
    assert all(np.isfinite(v) for v in out.values())
    assert 10.0 < out["soft_psnr_db"] < 60.0 and out["psnr_delta_db"] == out["ref_psnr_db"] - out["soft_psnr_db"]
    assert out["soft_psnr_db"] != out["ref_psnr_db"]  # the net moves the mid


def test_eval_vs_lanczos3_feeds_a_device_tensor():
    seen = []

    def fn(x):
        seen.append((type(x), x.device, x.dtype, tuple(x.shape)))
        return x.repeat_interleave(2, 1).repeat_interleave(2, 2).numpy()  # an array answer is taken too

    pdata.eval_vs_lanczos3(fn, seeds=(900,), device="cpu")
    assert seen == [(torch.Tensor, torch.device("cpu"), torch.float32, (1, 96, 96, 3))] * 2
