"""The port's live 4:2:0 link (nu_scaler_tpu_torch.ops.color, the
LivePipeline's ingest / deliver hooks, capture/video.py, ops/metrics.py)
against the JAX package's, on the CPU.

The same seeded numpy inputs go to both packages. Tolerances:

* the converters against the numpy goldens and against
  `nu_scaler_tpu.ops.color`: ±1 LSB, the JAX test's bound (tests/
  test_color.py): the port does the golden's fp32 operations one by one, in
  its order, and so equals it on ingest; JAX's compiled functions may
  contract a product and a sum into an FMA, and the chroma of the golden is
  clipped per pixel before its mean, so a truncation tie can move 1 LSB.
* the delivery with a preview: ±1 LSB (the area resample's fp32 sums in
  another order, then a truncating pack).
* the live pipelines (bilinear upscale, cross-fade): ±1 LSB per plane.
* copies of numpy code (goldens, Y4M, metrics): equal.
"""

import numpy as np
import pytest
import torch

from nu_scaler_tpu.capture import video as jvideo
from nu_scaler_tpu.ops import color as jcolor
from nu_scaler_tpu.ops import interpolate as jinterp
from nu_scaler_tpu.ops import metrics as jmetrics
from nu_scaler_tpu.ops import resample as jresample
from nu_scaler_tpu.runtime import streaming as jstreaming
from nu_scaler_tpu_torch.capture import video as pvideo
from nu_scaler_tpu_torch.ops import color as pcolor
from nu_scaler_tpu_torch.ops import interpolate as pinterp
from nu_scaler_tpu_torch.ops import metrics as pmetrics
from nu_scaler_tpu_torch.ops import resample as presample
from nu_scaler_tpu_torch.runtime import streaming as pstreaming

H, W = 64, 256


def _noise(seed: int, h: int = H, w: int = W) -> np.ndarray:
    f = np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = 255
    return f


def _smooth(h: int = H, w: int = W) -> np.ndarray:
    """In-gamut gradients (noise clips heavily on 4:2:0 reconstruction)."""
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.empty((h, w, 4), np.uint8)
    f[..., 0] = (64 + 128 * xx / w).astype(np.uint8)
    f[..., 1] = (64 + 128 * yy / h).astype(np.uint8)
    f[..., 2] = (64 + 64 * (xx + yy) / (w + h)).astype(np.uint8)
    f[..., 3] = 255
    return f


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _np(x):
    return tuple(p.numpy() for p in x) if isinstance(x, tuple) else x.numpy()


FRAMES = {"noise": lambda: _noise(0), "noise2": lambda: _noise(7), "smooth": _smooth}


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_yuv420_to_rgba_matches_golden_and_jax(kind):
    y, u, v = pvideo._rgba_to_yuv420(FRAMES[kind]())
    got = pcolor.make_yuv420_to_rgba(H, W, device="cpu")(y, u, v).numpy()
    golden = pvideo._yuv420_to_rgba(y, u, v)
    want = np.asarray(jcolor.make_yuv420_to_rgba(H, W)(y, u, v))
    assert got.shape == (H, W, 4) and got.dtype == np.uint8
    assert _lsb(got, golden) <= 1 and _lsb(got, want) <= 1
    # the golden's operations one by one, in its order: equal
    np.testing.assert_array_equal(got, golden)


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_rgba_to_yuv420_matches_golden_and_jax(kind):
    f = FRAMES[kind]()
    got = _np(pcolor.make_rgba_to_yuv420(H, W, device="cpu")(f))
    golden = pvideo._rgba_to_yuv420(f)
    want = tuple(np.asarray(p) for p in jcolor.make_rgba_to_yuv420(H, W)(f))
    for g, gold, j, shape in zip(got, golden, want, ((H, W), (H // 2, W // 2), (H // 2, W // 2))):
        assert g.shape == shape and g.dtype == np.uint8
        assert _lsb(g, gold) <= 1 and _lsb(g, j) <= 1


def test_roundtrip_preserves_luma():
    f = _smooth()
    y, u, v = pcolor.make_rgba_to_yuv420(H, W, device="cpu")(f)
    back = pcolor.make_yuv420_to_rgba(H, W, device="cpu")(y, u, v).numpy()
    y2, _, _ = pvideo._rgba_to_yuv420(back)
    assert _lsb(y2, y.numpy()) <= 2
    assert pmetrics.psnr(back, f) >= 40.0


@pytest.mark.parametrize("make", [pcolor.make_yuv420_to_rgba, pcolor.make_rgba_to_yuv420])
@pytest.mark.parametrize("dims", [(63, W), (H, 255)])
def test_odd_dims_rejected(make, dims):
    with pytest.raises(ValueError, match="even dims"):
        make(*dims, device="cpu")


def test_converters_check_shapes():
    y, u, v = pvideo._rgba_to_yuv420(_noise(1))
    with pytest.raises(ValueError, match="expected"):
        pcolor.make_yuv420_to_rgba(H, W, device="cpu")(y, u[:-1], v)
    with pytest.raises(ValueError, match="expected"):
        pcolor.make_rgba_to_yuv420(H, W, device="cpu")(_noise(1)[:-2])


def test_delivery_fn_identity_and_formats():
    assert pcolor.make_delivery_fn(H, W, "rgba", 0, device="cpu") is None
    assert jcolor.make_delivery_fn(H, W, "rgba", 0) is None
    d = pcolor.make_delivery_fn(H, W, "yuv420", 0, device="cpu")
    assert d.out_hw == (H, W) and d.fmt == "yuv420"
    f = _noise(3)
    got = _np(d(f))
    want = tuple(np.asarray(p) for p in jcolor.make_delivery_fn(H, W, "yuv420", 0)(f))
    for g, j in zip(got, want):
        assert g.shape == j.shape and _lsb(g, j) <= 1
    with pytest.raises(ValueError, match="unknown delivery format"):
        pcolor.make_delivery_fn(H, W, "nv12", 0, device="cpu")


@pytest.mark.parametrize("fmt", ["yuv420", "rgba"])
@pytest.mark.parametrize("preview_h", [32, 33, 22])
def test_delivery_fn_preview_matches_jax(fmt, preview_h):
    """The preview size by Python's round, as JAX's; the area resample and
    the packing within 1 LSB of JAX's."""
    d = pcolor.make_delivery_fn(H, W, fmt, preview_h, device="cpu")
    jd = jcolor.make_delivery_fn(H, W, fmt, preview_h)
    assert d.out_hw == jd.out_hw and d.fmt == fmt
    ph, pw = d.out_hw
    assert ph % 2 == 0 and pw % 2 == 0
    f = _smooth()
    got, want = d(f), jd(f)
    if fmt == "rgba":
        got, want = (got,), (want,)
    for g, j in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(j)) and _lsb(g.numpy(), np.asarray(j)) <= 1
    # the preview is the port's area resample, then the 4:2:0 pack
    rs = presample.make_resampler(H, W, ph, pw, "area", device="cpu")(f)
    if fmt == "yuv420":
        for g, r in zip(got, pcolor.make_rgba_to_yuv420(ph, pw, device="cpu")(rs)):
            assert torch.equal(g, r)
    else:
        assert torch.equal(got[0], rs)
    # a preview at or above the full height resamples nothing
    assert pcolor.make_delivery_fn(H, W, "rgba", preview_h=H, device="cpu") is None


@pytest.mark.parametrize("fmt, h, w", [("rgba", H, W), ("yuv420", H, W), ("yuv420", 2160, 3840),
                                       ("yuv420", 1080, 1920), ("rgba", 540, 960)])
def test_payload_bytes(fmt, h, w):
    assert pcolor.payload_bytes(fmt, h, w) == jcolor.payload_bytes(fmt, h, w)
    assert pcolor.payload_bytes(fmt, h, w) == (h * w * 4 if fmt == "rgba" else h * w * 3 // 2)


@pytest.mark.parametrize("preview_h", [0, 64])
def test_live_pipeline_planar_ingest_and_delivery_match_jax(preview_h):
    """4:2:0 tuples in, device payloads out, against the JAX LivePipeline fed
    the same planes (tests/test_color.py's set-up: bilinear ×2, cross-fade
    of the upscaled frames, depth 1)."""
    oh, ow = H * 2, W * 2
    jpipe = jstreaming.LivePipeline(
        jresample.make_resampler(H, W, oh, ow, "bilinear"),
        lambda a, b, t: jinterp.blend_only(a, b, t), depth=1, amortize_blend=True,
        ingest_fn=jcolor.make_yuv420_to_rgba(H, W),
        deliver_fn=jcolor.make_delivery_fn(oh, ow, "yuv420", preview_h),
    )
    ppipe = pstreaming.LivePipeline(
        presample.make_resampler(H, W, oh, ow, "bilinear", device="cpu"),
        pinterp.blend_only, device="cpu", depth=1, amortize_blend=True,
        ingest_fn=pcolor.make_yuv420_to_rgba(H, W, device="cpu"),
        deliver_fn=pcolor.make_delivery_fn(oh, ow, "yuv420", preview_h, device="cpu"),
    )
    outs_j, outs_p = [], []
    for i in range(4):
        planes = pvideo._rgba_to_yuv420(_smooth() if i % 2 else _noise(10 + i))
        outs_j += jpipe.put(planes)
        outs_p += ppipe.put(planes)
    outs_j += jpipe.drain()
    outs_p += ppipe.drain()
    assert len(outs_p) == len(outs_j) == 7 and ppipe.frames_out == 7
    dh, dw = (oh, ow) if not preview_h else (preview_h, ow * preview_h // oh)
    for pj, pp in zip(outs_j, outs_p):
        assert isinstance(pp, tuple) and len(pp) == 3
        assert pp[0].shape == (dh, dw) and pp[1].shape == pp[2].shape == (dh // 2, dw // 2)
        for a, b in zip(pj, pp):
            assert _lsb(a, b) <= 1


def test_live_pipeline_fused_step_with_hooks():
    """The fused resample + cross-fade step between the hooks: every payload
    is the delivery of the step's output on the ingested frame."""
    oh, ow = H * 2, W * 2
    ingest = pcolor.make_yuv420_to_rgba(H, W, device="cpu")
    deliver = pcolor.make_delivery_fn(oh, ow, "yuv420", device="cpu")
    step = presample.make_fused_blend(H, W, oh, ow, "lanczos3", 0.5, device="cpu")
    pipe = pstreaming.LivePipeline(None, device="cpu", depth=2, fused_step_fn=step,
                                   ingest_fn=ingest, deliver_fn=deliver)
    plain = pstreaming.LivePipeline(None, device="cpu", depth=2, fused_step_fn=step)
    outs, want = [], []
    for i in range(3):
        planes = pvideo._rgba_to_yuv420(_noise(20 + i))
        outs += pipe.put_device(planes)
        want += plain.put_device(ingest(*planes))
    outs += pipe.drain_device()
    want += plain.drain_device()
    assert len(outs) == len(want) == 5
    for o, w in zip(outs, want):
        for a, b in zip(o, deliver(w)):
            assert torch.equal(a, b)
    fetched = pstreaming._fetch(outs[0])
    assert isinstance(fetched, tuple) and all(isinstance(p, np.ndarray) for p in fetched)
    # an RGBA frame (not a tuple) skips the ingest; its outputs are delivered
    assert pipe.put_device(_noise(30)) == []
    extra = pipe.drain_device()
    assert len(extra) == 2 and all(isinstance(o, tuple) and len(o) == 3 for o in extra)


def test_benchmark_live_pipeline_keys_match_jax():
    frames = [_noise(40 + i, 16, 32) for i in range(6)]
    got = pstreaming.benchmark_live_pipeline(
        presample.make_resampler(16, 32, 32, 64, "bilinear", device="cpu"), pinterp.blend_only,
        frames, warmup=2, device="cpu")
    want = jstreaming.benchmark_live_pipeline(
        jresample.make_resampler(16, 32, 32, 64, "bilinear"),
        lambda a, b, t: jinterp.blend_only(a, b, t), frames, warmup=2)
    assert sorted(got) == sorted(want)
    assert got["output_frames"] == want["output_frames"] == 2 * 4
    assert got["seconds"] > 0 and got["fps"] > 0 and got["p99_step_ms"] >= got["p50_step_ms"] > 0


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_video_goldens_equal_jax(kind):
    f = FRAMES[kind]()
    planes = pvideo._rgba_to_yuv420(f)
    for a, b in zip(planes, jvideo._rgba_to_yuv420(f)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pvideo._yuv420_to_rgba(*planes), jvideo._yuv420_to_rgba(*planes))


def test_y4m_roundtrip_equals_jax(tmp_path):
    frames = [_noise(50 + i, 32, 48) for i in range(3)]
    paths = []
    for mod, name in ((pvideo, "port.y4m"), (jvideo, "jax.y4m")):
        w = mod.Y4MWriter(str(tmp_path / name), 48, 32, fps=30.0)
        for f in frames:
            w.write(f)
        w.close()
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    r = pvideo.Y4MReader(str(paths[0]))
    assert (r.width, r.height, r.fps) == (48, 32, 30.0)
    got = list(r)
    r.close()
    want = [jvideo._yuv420_to_rgba(*jvideo._rgba_to_yuv420(f)) for f in frames]
    assert len(got) == 3
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


def test_metrics_equal_jax():
    a, b = _noise(60), _smooth()
    pm, jm = pmetrics.ErrorMetrics.calculate(a, b), jmetrics.ErrorMetrics.calculate(a, b)
    assert (pm.mse, pm.psnr, pm.ssim) == (jm.mse, jm.psnr, jm.ssim)
    assert pmetrics.psnr(a, a) == float("inf")
    assert pmetrics.ssim(a[:4, :4], a[:4, :4]) == jmetrics.ssim(a[:4, :4], a[:4, :4]) == 1.0
    with pytest.raises(ValueError, match="same dimensions"):
        pmetrics.ErrorMetrics.calculate(a, b[:-1])
