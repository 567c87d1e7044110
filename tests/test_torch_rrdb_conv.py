"""RRDBNet's dense-block conv (`kernels/rrdb_conv_cuda.py`, `csrc/rrdb_conv.cu`):
its plain version against `F.conv2d` on a concatenated copy of the dense
features, for each conv of the served graph, and on channel-blocked views
against NHWC, on the CPU; on the card the kernel against its plain version
at the served shapes, on blocked operands as served and on NHWC, and a
whole `RRDBServing` frame against the fp32 reference.

This file imports no JAX, so that its card tests run on the card's machine:
``python3 -m pytest --noconftest tests/test_torch_rrdb_conv.py -m card``.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from nu_scaler_tpu_torch.kernels import rrdb_conv_cuda as rc
from nu_scaler_tpu_torch.models import rrdbnet
from nu_scaler_tpu_torch.models import rrdbnet_reference as ref

SLOPE, RES = rrdbnet.SLOPE, rrdbnet.RES
FEAT, GROW = 64, 32
WIDTH = FEAT + 4 * GROW  # a growth buffer's channels

# Each conv the served graph runs on the kernel: (Cin, Cout, epilogue).
# "lrelu" writes the buffer's slice after its prefix; "rdb" is conv5 with the
# RDB's residual x (the buffer's first channels); "rrdb" adds the RRDB's
# residual x0 too, written over x0 in place; "body" is conv_body with f0;
# "up" an upsampling conv on a tensor of its own.
CASES = [(FEAT + k * GROW, GROW, "lrelu") for k in range(4)] + [
    (WIDTH, FEAT, "rdb"), (WIDTH, FEAT, "rrdb"), (FEAT, FEAT, "body"), (FEAT, FEAT, "up")]
IDS = [f"conv{k + 1}" for k in range(4)] + ["conv5", "conv5_rrdb", "conv_body", "conv_up"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python3 -m pytest --noconftest "
                    "tests/test_torch_rrdb_conv.py -m card` on the H100")
    return torch.device("cuda", 0)


def _conv(cin: int, cout: int, g: torch.Generator, device, dtype=torch.float16) -> rc.Conv:
    w = torch.randn(cout, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5
    b = torch.randn(cout, generator=g) * 0.1
    return rc.make_conv(w, b, device, dtype)


def _operands(cin: int, cout: int, kind: str, n: int, h: int, w: int, device, seed: int = 0,
              layout: str = "nhwc"):
    """(src, conv, out, epilogue kwargs) of one case, the same values for the
    same seed: the growth buffer (or a tensor of its own for "body" and
    "up") and the output view, NHWC or, with ``layout="blocked"``,
    channel-blocked as `RRDBServing` holds them (conv_body's residual f0
    stays NHWC)."""
    device = torch.device(device)
    g = torch.Generator().manual_seed(seed)
    conv = _conv(cin, cout, g, device)
    gd = torch.Generator(device=device).manual_seed(seed)

    def randn(c: int) -> torch.Tensor:
        return torch.randn(n, h, w, c, generator=gd, device=device).to(torch.float16)

    def laid(t: torch.Tensor) -> torch.Tensor:
        return rc.to_blocked(t) if layout == "blocked" else t

    if kind in ("body", "up"):
        out = laid(torch.full((n, h, w, cout), 7.0, dtype=torch.float16, device=device))
        return laid(randn(cin)), conv, out, dict(res=randn(cout)) if kind == "body" else dict(slope=SLOPE)
    buf = laid(randn(WIDTH))
    if kind == "lrelu":
        return buf, conv, rc.channel_slice(buf, cin, cin + cout), dict(slope=SLOPE)
    out = rc.channel_slice(laid(randn(WIDTH)), 0, FEAT)  # channels 0-63 of the next RDB's buffer
    epi = dict(res=rc.channel_slice(buf, 0, FEAT), res_scale=RES)
    if kind == "rrdb":
        epi.update(res2=out, res2_scale=RES)
    return buf, conv, out, epi


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The tensor a view was cut from, in the view's layout (itself if it is
    no view)."""
    if t._base is None:
        return t
    return t._base if t.dim() == 4 else t._base.permute(0, 2, 3, 1, 4)


def _outside(view: torch.Tensor) -> torch.Tensor:
    """The mask of the channels of `_whole(view)` that the view does not hold."""
    whole = _whole(view)
    off = view.storage_offset() - whole.storage_offset()
    lo = off % whole.shape[-1] if view.dim() == 4 else off // (view.shape[1] * view.shape[2])
    keep = torch.ones(rc.channels(whole), dtype=torch.bool, device=view.device)
    keep[lo:lo + rc.channels(view)] = False
    return keep


def _want(src, cin, conv, epi, dtype) -> torch.Tensor:
    """`F.conv2d` of a concatenated copy of the prefix, in fp32, then the
    epilogue in fp32, rounded to `dtype`."""
    feats = [src[..., :FEAT]] + [src[..., c:c + GROW] for c in range(FEAT, cin, GROW)]
    x = torch.cat(feats, -1).permute(0, 3, 1, 2).float()
    v = F.conv2d(x, conv.weight.float(), padding=1).permute(0, 2, 3, 1) + conv.bias
    return rc.epilogue(v, epi.get("slope"), epi.get("res"), epi.get("res_scale", 1.0), epi.get("res2"),
                       epi.get("res2_scale", 1.0)).to(dtype)


@pytest.mark.parametrize("cin,cout,kind", CASES, ids=IDS)
def test_plain_version_is_the_conv_of_the_concatenation(cin, cout, kind):
    """The plain version (`rrdb_conv`, CPU tensors) writes what `F.conv2d`
    gives on a concatenated copy of the prefix, with the epilogue, into its
    slice, and leaves every other channel of the buffers as it was."""
    src, conv, out, epi = _operands(cin, cout, kind, 2, 9, 13, "cpu")
    before_src, before_out = src.clone(), _whole(out).clone()
    want = _want(src, cin, conv, epi, torch.float16)
    tol = rc.ulp_tolerance(src, conv, want.float(), epi.get("res_scale", 1.0), epi.get("res2_scale", 1.0))
    got = rc.rrdb_conv(src, conv, out, **epi)
    assert got is out
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert float((got != want).float().mean()) < 0.02  # the two sums round alike nearly everywhere
    keep = _outside(out)
    assert torch.equal(_whole(out)[..., keep], before_out[..., keep])
    if _whole(out) is not src:
        assert torch.equal(src, before_src)


@pytest.mark.parametrize("cin,cout,kind", CASES, ids=IDS)
def test_plain_version_on_blocked_views_equals_nhwc(cin, cout, kind):
    """The wrapper on blocked operands (CPU: the plain version) writes the
    same values as on NHWC ones, and leaves the same other channels as they
    were: the result does not depend on the layout."""
    src, conv, out, epi = _operands(cin, cout, kind, 2, 9, 13, "cpu")
    bsrc, bconv, bout, bepi = _operands(cin, cout, kind, 2, 9, 13, "cpu", layout="blocked")
    assert bsrc.dim() == 5 and bout.dim() == 5
    assert torch.equal(rc.to_nhwc(bsrc), src) and torch.equal(rc.to_nhwc(_whole(bout)), _whole(out))
    rc.rrdb_conv(src, conv, out, **epi)
    rc.rrdb_conv(bsrc, bconv, bout, **bepi)
    assert torch.equal(rc.to_nhwc(_whole(bout)), _whole(out))
    assert torch.equal(rc.to_nhwc(bsrc), src)


def test_blocked_buffer_round_trips_nhwc():
    """`to_blocked` lays 8-channel planes one after another (memory [N, C/8,
    H, W, 8]) and `to_nhwc` gives the tensor back exactly; a channel slice
    of whole blocks is the same channels in either layout."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 5, 7, WIDTH, generator=g).to(torch.float16)
    b = rc.to_blocked(x)
    assert b.shape == (2, 5, 7, WIDTH // 8, 8) and rc.channels(b) == WIDTH
    assert b.permute(0, 3, 1, 2, 4).is_contiguous()
    assert rc.strides("b", b) == (WIDTH * 5 * 7, 5 * 7 * 8, 8)
    assert rc.strides("x", x) == (5 * 7 * WIDTH, 8, WIDTH)
    assert torch.equal(rc.to_nhwc(b), x)
    assert torch.equal(b[1, 3, 4, 9], x[1, 3, 4, 72:80])
    part = rc.channel_slice(b, FEAT, FEAT + GROW)
    assert rc.strides("part", part) == (WIDTH * 5 * 7, 5 * 7 * 8, 8)
    assert torch.equal(rc.to_nhwc(part), rc.channel_slice(x, FEAT, FEAT + GROW))
    assert rc.strides("one", rc.to_blocked(x[:1]))[0] == 0  # one image: no image stride


def test_wrapper_refuses_unaligned_slices_and_other_layouts():
    """The kernel's operands are NHWC views or blocked views, their channels
    from a multiple of 8: a slice that starts inside a block, a 5-D view
    that is NHWC cut into blocks, blocks of another width and a view with
    its positions out of order are refused."""
    x = torch.zeros(1, 4, 6, WIDTH, dtype=torch.float16)
    b = rc.to_blocked(x)
    for name, t in (("inside a block", x[..., 4:36]), ("5-D NHWC", x.unflatten(-1, (-1, 8))),
                    ("positions transposed", b.transpose(1, 2)), ("half blocks", b[..., :4]),
                    ("odd channels", x[..., :12])):
        with pytest.raises(ValueError, match="8-aligned"):
            rc.strides(name, t)
    with pytest.raises(ValueError, match="whole blocks"):
        rc.channel_slice(b, 4, 36)
    with pytest.raises(ValueError, match="blocks of 8"):
        rc.blocked(1, 4, 6, 12, torch.float16, "cpu")
    conv = _conv(FEAT, GROW, torch.Generator().manual_seed(7), "cpu")
    with pytest.raises(ValueError, match=r"blocked \[N, H, W, C/8, 8\]"):
        rc.rrdb_conv(b[..., :4], conv, rc.channel_slice(b, FEAT, FEAT + GROW))


def test_pack_weights_layout():
    w = torch.arange(64 * 96 * 9, dtype=torch.float32).reshape(64, 96, 3, 3)
    p = rc.pack_weights(w)
    assert p.shape == (6, 9, 2, 64, 8) and p.is_contiguous()
    for q, t, gr, o, e in ((0, 0, 0, 0, 0), (5, 8, 1, 63, 7), (3, 4, 0, 17, 5)):
        assert p[q, t, gr, o, e] == w[o, 16 * q + 8 * gr + e, t // 3, t % 3]
    with pytest.raises(ValueError, match="16k"):
        rc.pack_weights(torch.zeros(32, 12, 3, 3))


def test_cpu_runs_the_plain_version_in_any_float_dtype():
    """On the CPU the wrapper takes fp32 too (the fp32 serving graph of the
    tests), and launches nothing."""
    g = torch.Generator().manual_seed(3)
    conv = _conv(FEAT, GROW, g, "cpu", torch.float32)
    buf = torch.randn(1, 5, 6, WIDTH, generator=g)
    rc.reset_launches()
    rc.rrdb_conv(buf, conv, buf[..., FEAT:FEAT + GROW], slope=SLOPE)
    assert rc.launches["rrdb_conv"] == 0
    want = _want(buf, FEAT, conv, dict(slope=SLOPE), torch.float32)
    assert torch.allclose(buf[..., FEAT:FEAT + GROW], want, rtol=1e-5, atol=1e-5)


def test_launch_refuses_what_the_kernel_does_not_take():
    g = torch.Generator().manual_seed(4)
    conv = _conv(FEAT, GROW, g, "cpu")
    buf = torch.zeros(1, 4, 4, WIDTH, dtype=torch.float16)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        rc._launch(buf, conv, buf[..., FEAT:FEAT + GROW], SLOPE, None, 1.0, None, 1.0)
    with pytest.raises(ValueError, match="expected"):
        rc.rrdb_conv(buf, conv, torch.zeros(1, 4, 4, FEAT, dtype=torch.float16))
    with pytest.raises(ValueError, match="reads 64 channels"):
        rc.rrdb_conv(buf[..., :32], conv, buf[..., FEAT:FEAT + GROW])
    with pytest.raises(ValueError, match="give res too"):
        rc.rrdb_conv(buf, conv, buf[..., FEAT:FEAT + GROW], res2=buf[..., :GROW])
    with pytest.raises(ValueError, match="evenly spaced"):
        rc.strides("out", buf.permute(0, 2, 1, 3))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("layout", ["blocked", "nhwc"])
@pytest.mark.parametrize("cin,cout,kind", CASES, ids=IDS)
def test_kernel_equals_plain_at_the_served_shapes(card, cin, cout, kind, layout):
    """Each conv at the body's 540×960 (the upsampling conv at 4K), kernel
    against plain version on the same operands, blocked as served and NHWC:
    within one fp16 ulp (and, where the sum cancels, the fp32 rounding of
    its terms), every other channel untouched, one launch counted (as
    "blocked" where src is)."""
    h, w = (2160, 3840) if kind == "up" else (540, 960)
    src_p, conv_p, out_p, epi_p = _operands(cin, cout, kind, 1, h, w, card, seed=cin + cout, layout=layout)
    plain = rc.rrdb_conv_plain(src_p, conv_p, out_p, **epi_p)
    src, conv, out, epi = _operands(cin, cout, kind, 1, h, w, card, seed=cin + cout, layout=layout)
    before_src, before_out = src.clone(), rc.to_nhwc(_whole(out)).clone()
    rc.reset_launches()
    got = rc.rrdb_conv(src, conv, out, **epi)
    torch.cuda.synchronize()
    assert rc.launches == {"rrdb_conv": 1, "blocked": int(layout == "blocked")}
    tol = rc.ulp_tolerance(src, conv, plain.float(), epi.get("res_scale", 1.0), epi.get("res2_scale", 1.0))
    assert bool(((got.float() - plain.float()).abs() <= tol).all())
    assert float((got != plain).float().mean()) < 0.02
    keep = _outside(out)
    assert torch.equal(rc.to_nhwc(_whole(out))[..., keep], before_out[..., keep])
    if _whole(out).data_ptr() != src.data_ptr():
        assert torch.equal(src, before_src)


def _seeded_state(seed: int = 5) -> dict:
    torch.manual_seed(seed)
    model = rrdbnet.RRDBNet(**rrdbnet.X2PLUS)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.startswith("body.") and isinstance(m, torch.nn.Conv2d):
                torch.nn.init.kaiming_normal_(m.weight)
                m.bias.zero_()
        model.conv_last.weight.mul_(0.25)
        model.conv_last.bias.fill_(0.8)
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.card
def test_served_frame_against_the_fp32_reference(card):
    """A whole frame through `RRDBServing` in fp16 on the card (the body at
    135×240: ragged tiles at both edges) against BasicSR's forward in fp32:
    at most 2 LSB apart, and most bytes equal, as on the CPU."""
    state = _seeded_state()
    model = rrdbnet.RRDBNet(**rrdbnet.X2PLUS)
    model.load_state_dict(state)
    g = torch.Generator().manual_seed(9)
    h, w = 270, 480
    img = torch.randint(0, 256, (h, w, 4), generator=g, dtype=torch.uint8)
    img[60:200, 100:380, :3] = img[60:200, 100:380, :3] // 4 + 100
    img = img.to(card)
    serving = rrdbnet.RRDBServing(model.eval(), h, w, 2 * h, 2 * w, card)
    rrdbnet.reset_launches()
    rc.reset_launches()
    got = serving(img[None])[0]
    assert rrdbnet.launches == {"rrdb_conv": 349, "conv": 2}
    assert rc.launches == {"rrdb_conv": 349, "blocked": 349}
    want = ref.upscale(img, state)
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert int(d.max()) <= 2
    assert float(d.bool().float().mean()) < 0.15
