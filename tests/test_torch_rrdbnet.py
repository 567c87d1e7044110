"""Real-ESRGAN's RRDBNet ×2 on the port (`models/rrdbnet.py`, the
"realesrgan" ladder) against its plain reference (`models/rrdbnet_reference.py`,
BasicSR's forward in fp32), at the published widths (23 RRDBs of 64 features,
32-channel growth) on a 16×24 RGBA frame, with seeded weights."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nu_scaler_tpu.models import esrgan_lite as el
from nu_scaler_tpu_torch.core.upscaler import PyAdvancedWgpuUpscaler
from nu_scaler_tpu_torch.models import esrgan_lite as pel
from nu_scaler_tpu_torch.models import rrdbnet, train
from nu_scaler_tpu_torch.models import rrdbnet_reference as ref
from nu_scaler_tpu_torch.utils import tracing

H, W = 16, 24
CPU = torch.device("cpu")


def seeded_state(seed: int = 3) -> dict:
    """BasicSR's init with the benchmark configuration's scales: the dense
    blocks' convs Kaiming normal (no ×0.1), bias 0; the others PyTorch's
    default; `conv_last` ×0.25 with bias 0.8, so the output spreads around
    mid-grey."""
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


@pytest.fixture(scope="module")
def state():
    return seeded_state()


@pytest.fixture(scope="module")
def root(tmp_path_factory, state):
    d = tmp_path_factory.mktemp("ckpt_root")
    rrdbnet.write_weights(d, state, step=7, source="seeded")
    return d


@pytest.fixture
def served(root, monkeypatch):
    monkeypatch.setattr(train, "CKPT_ROOT", root)
    return root


@pytest.fixture(scope="module")
def model(state):
    m = rrdbnet.RRDBNet(**rrdbnet.X2PLUS)
    m.load_state_dict(state)
    return m.eval()


@pytest.fixture(scope="module")
def frame():
    g = torch.Generator().manual_seed(11)
    img = torch.randint(0, 256, (H, W, 4), generator=g, dtype=torch.uint8)
    img[4:12, 6:18, :3] = img[4:12, 6:18, :3] // 4 + 100  # a flat patch with edges
    return img


@pytest.fixture(scope="module")
def want(state, frame):
    return ref.upscale(frame, state)


def serve(model, frame, dtype=torch.float16) -> torch.Tensor:
    return rrdbnet.RRDBServing(model, H, W, 2 * H, 2 * W, CPU, dtype)(frame[None])[0]


def near_ties(state, frame) -> torch.Tensor:
    """Where the reference's value ·255 sits within 1e-3 of a rounding tie:
    RGB from the net, alpha from its bilinear ×2 (whose quarter weights put
    many alpha values on a tie exactly)."""
    x = frame[..., :3].permute(2, 0, 1)[None].float() / 255.0
    a = frame[..., 3].float()[None, None]
    with torch.no_grad():
        y = ref.net(x, state, 23)[0].clamp(0, 1).permute(1, 2, 0) * 255.0
    a = torch.nn.functional.interpolate(a, scale_factor=2, mode="bilinear", align_corners=False)[0, 0]
    y = torch.cat([y, a[..., None]], dim=-1)
    return (y - torch.floor(y) - 0.5).abs() < 1e-3


def diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int16) - b.to(torch.int16)).abs()


def test_fp32_equals_the_reference_but_at_ties(model, state, frame, want):
    d = diff(serve(model, frame, torch.float32), want)
    assert int(d.max()) <= 1
    assert not bool((d.bool() & ~near_ties(state, frame)).any())


def test_fp16_within_two_lsb(model, frame, want):
    """fp16 keeps 11 bits of every activation through 351 convs and 92
    residual adds; the features grow about 1.2× an RRDB, so each add's
    rounding is a fixed share of the signal. Through the last conv that is
    well under an LSB of the output spread, but it tips some roundings: 2
    LSB is the bound, and most bytes agree."""
    d = diff(serve(model, frame), want)
    assert int(d.max()) <= 2
    assert float(d.bool().float().mean()) < 0.15


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_planted_fault_breaks_the_comparison(model, state, frame, fault):
    d = diff(serve(model, frame, torch.float32), ref.upscale(frame, state, fault=fault))
    off_ties = d.bool() & ~near_ties(state, frame)
    assert float(off_ties.float().mean()) > 0.05, fault


def test_pixel_unshuffle_order():
    """Channel c·4 + dy·2 + dx of the 2×2 cell holds colour c at (dy, dx)."""
    img = torch.arange(16, dtype=torch.uint8).reshape(1, 2, 2, 4) * 10
    m = rrdbnet.RRDBNet(num_block=1, scale=2)
    x = rrdbnet.RRDBServing(m, 2, 2, 4, 4, CPU, torch.float32).prepare(img)
    assert x.shape == (1, 12, 1, 1)
    for c in range(3):
        for dy in range(2):
            for dx in range(2):
                assert float(x[0, c * 4 + dy * 2 + dx, 0, 0]) == np.float32(img[0, dy, dx, c]) / np.float32(255)


def test_basicsr_names_round_trip(root, state):
    meta = json.loads((root / "esrgan_rrdbnet_x2_7.json").read_text())
    assert meta["arch"] == "rrdbnet" and meta["parameters"] == 16703171 and meta["model"] == rrdbnet.X2PLUS
    tree = pel.read_weights(root / "esrgan_rrdbnet_x2_7.npz", meta["sha256"])
    assert list(tree) == list(state)
    for name in ("conv_first.weight", "body.0.rdb1.conv1.weight", "body.22.rdb3.conv5.bias",
                 "conv_body.weight", "conv_up1.bias", "conv_up2.weight", "conv_hr.weight", "conv_last.bias"):
        assert np.array_equal(tree[name], state[name].numpy()), name
    assert tree["body.3.rdb2.conv4.weight"].shape == (32, 160, 3, 3)  # OIHW
    # a published params_ema dict loads into the module as it is
    rrdbnet.RRDBNet(**rrdbnet.X2PLUS).load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    assert rrdbnet.npz_bytes(tree) == (root / "esrgan_rrdbnet_x2_7.npz").read_bytes()


def test_ladder_serves_through_the_advanced_upscaler(served, model, frame):
    up = PyAdvancedWgpuUpscaler("ultra", "bilinear", True, "cpu")
    up.learned_prefer = "realesrgan"
    up.initialize(W, H, 2 * W, 2 * H)
    assert (up._fn.arch, up._fn.step, up._fn.directory) == ("rrdbnet", 7, served)
    got = np.frombuffer(up.upscale(frame.numpy().tobytes()), np.uint8).reshape(2 * H, 2 * W, 4)
    assert np.array_equal(got, serve(model, frame).numpy())
    batch = pel.make_pretrained_batch_upscaler(H, W, 2 * H, 2 * W, "realesrgan", "cpu")(frame[None].repeat(2, 1, 1, 1))
    assert np.array_equal(batch[1].numpy(), got)


def test_ladder_raises_without_weights(tmp_path, monkeypatch):
    monkeypatch.setattr(train, "CKPT_ROOT", tmp_path)
    up = PyAdvancedWgpuUpscaler("ultra", "bilinear", True, "cpu")
    up.learned_prefer = "realesrgan"
    with pytest.raises(ValueError, match="rrdbnet"):
        up.initialize(W, H, 2 * W, 2 * H)
    assert not up._initialized
    assert pel.ARCH_LADDER == el._ARCH_LADDER and "realesrgan" not in pel.ARCH_LADDER


def test_other_sizes(model, frame):
    """An odd side is reflect-padded and cropped back; another ratio resizes
    the ×2 output."""
    odd = rrdbnet.RRDBServing(model, H - 1, W - 1, 2 * H - 2, 2 * W - 2, CPU)(frame[None, 1:, 1:])[0]
    assert odd.shape == (2 * H - 2, 2 * W - 2, 4)
    other = rrdbnet.RRDBServing(model, H, W, 40, 60, CPU)(frame[None])[0]
    assert other.shape == (40, 60, 4)


def test_spans_and_counters(model, frame, monkeypatch):
    serving = rrdbnet.RRDBServing(model, H, W, 2 * H, 2 * W, CPU, torch.float32)
    rrdbnet.reset_launches()
    layouts = []  # each rrdb_conv call's src, as the kernel would read it
    conv = rrdbnet.rrdb_conv

    def counted(src, *args, **kwargs):
        layouts.append("blocked" if src.dim() == 5 else "nhwc")
        return conv(src, *args, **kwargs)

    monkeypatch.setattr(rrdbnet, "rrdb_conv", counted)
    tracing.enable()
    try:
        serving(frame[None])
    finally:
        tracing.disable()
    spans = tracing.drain()["spans"]
    names = {s["name"] for s in spans}
    stages = ("unshuffle", "first", "body", "rrdb", "conv_body", "upsample", "up1", "up2", "hr", "last", "pack")
    assert names == {"nu.models.rrdb"} | {f"nu.models.rrdb.{s}" for s in stages}
    assert sorted(s["index"] for s in spans if s["name"] == "nu.models.rrdb.rrdb") == list(range(23))
    # 69 RDBs of 5 convs, conv_body and the three upsampling convs on the
    # growth-buffer kernel's wrapper, every one on a blocked input; conv_first
    # and conv_last on F.conv2d
    assert rrdbnet.launches == {"rrdb_conv": 69 * 5 + 1 + 3, "conv": 2}
    assert layouts == ["blocked"] * (69 * 5 + 1 + 3)
    rrdbnet.reset_launches()
    assert rrdbnet.launches == {"rrdb_conv": 0, "conv": 0}


def test_newest_step_serves(tmp_path, monkeypatch, state):
    """Of two steps in the trainer's root the newer serves, and its sha256 is
    checked against its sidecar."""
    rrdbnet.write_weights(tmp_path, state, step=3)
    rrdbnet.write_weights(tmp_path, {k: v * 0.5 for k, v in state.items()}, step=12)
    monkeypatch.setattr(train, "CKPT_ROOT", tmp_path)
    assert pel.make_pretrained_upscaler(H, W, 2 * H, 2 * W, "realesrgan", "cpu").step == 12
    other = tmp_path / "tampered"
    rrdbnet.write_weights(other, state, step=3)
    (other / "esrgan_rrdbnet_x2_3.npz").write_bytes(rrdbnet.npz_bytes({"conv_first.weight": np.zeros(1)}))
    monkeypatch.setattr(train, "CKPT_ROOT", other)
    with pytest.raises(ValueError, match="sha256"):
        pel.make_pretrained_upscaler(H, W, 2 * H, 2 * W, "realesrgan", "cpu")


def test_reference_imports_torch_only():
    tree = ast.parse(Path(ref.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names == {"torch", "torch.nn.functional"}
