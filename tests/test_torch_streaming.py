"""The port's frame pipelines (nu_scaler_tpu_torch.runtime.streaming) against
the JAX package's, on the CPU.

The slice as a whole: the port's LivePipeline with its fused resample +
cross-fade step against the JAX LivePipeline driven by the Pallas
`make_pallas_fused_blend` kernel (interpret mode), set up as
tests/test_streaming.py sets it up. Bound: ≤2 LSB per frame, the same bound
as the kernel comparisons (the Pallas kernel rounds its vertical
intermediate to bf16; the port keeps fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.kernels.resample_pallas import make_pallas_fused_blend
from nu_scaler_tpu.ops import interpolate as jinterp
from nu_scaler_tpu.ops import resample as jresample
from nu_scaler_tpu.runtime import streaming as jstreaming
from nu_scaler_tpu_torch.ops import interpolate as pinterp
from nu_scaler_tpu_torch.ops import resample as presample
from nu_scaler_tpu_torch.runtime import streaming as pstreaming


def _frames(rng, n, h=16, w=16):
    return [rng.integers(0, 256, (h, w, 4), np.uint8) for _ in range(n)]


def _max_lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def test_live_pipeline_fused_step_matches_jax(rng):
    h, w = 128, 256
    frames = _frames(rng, 5, h=h, w=w)
    up = jresample.make_resampler(h, w, 2 * h, 2 * w, "lanczos3")
    jax_pipe = jstreaming.LivePipeline(
        up, lambda a, b, t: jinterp.blend_only(a, b, t), depth=1,
        fused_step_fn=make_pallas_fused_blend(h, w, 2 * h, 2 * w, "lanczos3", 0.5),
    )
    step = presample.make_fused_blend(h, w, 2 * h, 2 * w, "lanczos3", 0.5, device="cpu")
    port_pipe = pstreaming.LivePipeline(None, device="cpu", depth=1, fused_step_fn=step)
    outs_j, outs_p = [], []
    for f in frames:
        outs_j += jax_pipe.put(f)
        outs_p += port_pipe.put(f)
    outs_j += jax_pipe.drain()
    outs_p += port_pipe.drain()
    assert len(outs_j) == len(outs_p) == 1 + 2 * (len(frames) - 1)
    assert port_pipe.frames_in == 5 and port_pipe.frames_out == 9
    for i, (a, b) in enumerate(zip(outs_j, outs_p)):
        assert b.shape == (2 * h, 2 * w, 4) and b.dtype == np.uint8
        print(f"live frame {i}: max {_max_lsb(a, b)} LSB vs JAX")
        assert _max_lsb(a, b) <= 2
    # the order: first upscale, then (mid, cur) for each later frame; the
    # first and every odd frame are the plain upscale of an input frame
    rs = presample.make_resampler(h, w, 2 * h, 2 * w, "lanczos3", device="cpu")
    for k, f in enumerate(frames):
        np.testing.assert_array_equal(outs_p[2 * k], rs(f).numpy())


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("branch", ["fused", "amortized", "naive", "no_interp"])
def test_live_pipeline_counts_match_jax(rng, branch, depth):
    """Every branch of the live tick emits the same number of frames per put
    and in all as the JAX pipeline, with contents equal to rounding."""
    h, w = 16, 16
    frames = _frames(rng, 4, h=h, w=w)
    jup = jresample.make_resampler(h, w, 2 * h, 2 * w, "bilinear", "highest")
    pup = presample.make_resampler(h, w, 2 * h, 2 * w, "bilinear", device="cpu")
    jblend = lambda a, b, t: jinterp.blend_only(a, b, t)  # noqa: E731
    kw_j = dict(depth=depth)
    kw_p = dict(depth=depth, device="cpu")
    if branch == "fused":
        kw_j["fused_step_fn"] = make_pallas_fused_blend(h, w, 2 * h, 2 * w, "bilinear", 0.5)
        kw_p["fused_step_fn"] = presample.make_fused_blend(
            h, w, 2 * h, 2 * w, "bilinear", 0.5, device="cpu")
    if branch == "amortized":
        kw_j["amortize_blend"] = kw_p["amortize_blend"] = True
    interp_j = None if branch == "no_interp" else jblend
    interp_p = None if branch == "no_interp" else pinterp.blend_only
    jp = jstreaming.LivePipeline(jup, interp_j, **kw_j)
    pp = pstreaming.LivePipeline(pup, interp_p, **kw_p)
    outs_j, outs_p = [], []
    for f in frames:
        rj, rp = jp.put(f), pp.put(f)
        assert len(rj) == len(rp)
        outs_j += rj
        outs_p += rp
    outs_j += jp.drain()
    outs_p += pp.drain()
    assert len(outs_j) == len(outs_p) == (4 if branch == "no_interp" else 7)
    assert pp.frames_out == jp.frames_out == len(outs_p)
    for a, b in zip(outs_j, outs_p):
        assert _max_lsb(a, b) <= 1


def test_frame_pipeline_order_and_results(rng):
    fn = presample.make_resampler(16, 16, 32, 32, "bilinear", device="cpu")
    pipe = pstreaming.FramePipeline(fn, device="cpu", depth=2)
    frames = _frames(rng, 6)
    outs = list(pipe.process_stream(frames))
    assert len(outs) == 6
    jfn = jresample.make_resampler(16, 16, 32, 32, "bilinear", "highest")
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o, fn(f).numpy())
        assert _max_lsb(o, jfn(jnp.asarray(f))) <= 1  # fp32 summation order


def test_blend_only_matches_jax(rng):
    """The port's cross-fade is the JAX blend_only, bit for bit, including
    the exact-half ties."""
    a = rng.integers(0, 256, (33, 17, 4), np.uint8)
    b = rng.integers(0, 256, (33, 17, 4), np.uint8)
    for t in (0.5, 1 / 3, 2 / 3, 0.0, 1.0, 0.25):
        want = np.asarray(jinterp.blend_only(jnp.asarray(a), jnp.asarray(b), t))
        got = pinterp.blend_only(torch.from_numpy(a), torch.from_numpy(b), t).numpy()
        np.testing.assert_array_equal(got, want)
