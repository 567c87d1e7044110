"""Time and check Real-ESRGAN's RRDBNet ×2 (`models/rrdbnet.py`) on an NVIDIA
card at 1080p → 4K, with the seeded weights of the benchmark's
configuration `realesrgan_x2plus_fp16`.

Run from the root of a checkout, on a machine with a card:

    python3 tools/rrdb_probe.py [--phase forms,frames,stages,check,tail,sums] [--seed N]
        [--seeds N] [--seed-step N] [--check-frames N] [--frames N]
    python3 tools/rrdb_probe.py --phase witness --witness DIR [--device cpu]

Phases (each prints JSON lines, the last line of all a summary):

- ``forms``: one RDB at 540×960 in fp16 in each form of its dense
  connections (`FORMS`: the served growth buffers on `rrdb_conv`, and the
  concatenation on cuDNN served before the kernel, `CatForm`), the median of 20 CUDA-event timings
  after 3 warm-ups; then each conv the kernel runs (the RDB's five, the
  RRDB's conv5, `conv_body`, the upsampling convs at 1080p and 4K): the
  kernel on its operands as served (channel-blocked), its plain version
  and `F.conv2d` (the library yardstick, with and without its LeakyReLU
  pass) beside the conv's bound, and the kernel's
  registers and spills as ptxas printed them;
- ``frames``: the whole serving graph (u8 RGBA in, u8 RGBA out) in each
  form, the median of 8 frames, the memory peak, the bytes concatenated
  and the launches by kind;
- ``stages``: device ms a frame by ``nu.models.rrdb.*`` stage (a CUDA
  event pair around each of the program's spans), and two profiled frames:
  the device operations by name, and their count;
- ``check``: `--check-frames` frames of the 4:2:0 traffic from each of
  `--seeds` seeds (`--seed`, then every `--seed-step` on) through the
  program in each of `CHECK_FORMS` (the kernel's, `"plain"`: the same graph
  with `rrdb_conv_plain` in the kernel's place, so the same single rounding
  after full fp32 sums, the concatenation's `"cat"`, and the kernel's and cat's with
  conv_last's bias as in fp32, `LAST_BIAS`), and for the first seed the
  benchmark's bf16 control and each planted fault (in fp16), all compared
  with the fp32 reference through the 4:2:0 delivery as the benchmark
  compares them, and the output's spread and clamped share;
- ``sums``: each conv the kernel runs, at its served shape on seeded
  operands: the kernel's and the plain version's outputs against the exact
  value (the sums, bias and epilogue in fp64) rounded once to fp16 — the
  share rounded otherwise, the mean signed error in fp16 ulps towards larger
  magnitude, and the kernel against the plain version in units of
  `ulp_tolerance` and of fp16 ulps; then the bare sums (zero bias, the
  LeakyReLU instance, its positive outputs) of the kernel, the plain
  version and `F.conv2d` (cuDNN, fp16) against the same exact values;
- ``witness``: the program at `WITNESS_HW` (input; a small frame, so the
  CPU can run it) on the first frames of three seeds, kernel and plain
  forms on the card, the plain form with `--device cpu`, each against the
  fp32 reference on its own device; the card writes its outputs under
  `--witness`, the CPU run reads them and counts the bytes in which its
  plain form differs from the card's two forms;
- ``tail``: the program against the fp32 reference on `--frames` frames of
  the traffic (6 a seed from `--seed` on), the 4:2:0 payload's bytes
  counted by their difference in LSB, and the RGB bytes' too.

Exits non-zero without a card, but for ``witness`` with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import frames, registry, trace  # noqa: E402
from portbench.links import yuv420  # noqa: E402
from portbench.reference import rrdbnet as bref  # noqa: E402

CONFIG = "realesrgan_x2plus_fp16"
SLOPE, RES = 0.2, 0.2  # rrdbnet.SLOPE, rrdbnet.RES


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def card_name() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def serve_dir(cfg: dict) -> Path:
    from nu_scaler_tpu_torch.models import train

    d = Path(tempfile.mkdtemp(prefix="rrdb_probe-"))
    bref.write_checkpoint(bref.seeded_state(cfg), d, cfg)
    train.CKPT_ROOT = d
    return d


class CatForm:
    """The graph served before the kernel, kept as the yardstick of its form: every
    conv on `F.conv2d` (cuDNN, fp16, channels-last, its bias inside), the
    dense connections concatenated (`torch.cat` of every prefix, its bytes
    counted in `glue_bytes`), LeakyReLU and the residual adds as passes of
    their own. It takes over `serving.net`."""

    def __init__(self, serving) -> None:
        self.s = serving
        self.glue_bytes = 0
        self.convs = 0
        self.rrdbs = [[[self.nchw(c) for c in convs] for convs in rdbs] for rdbs in serving.rrdbs]
        self.conv_body, self.up1, self.up2, self.hr = (
            self.nchw(c) for c in (serving.conv_body, serving.up1, serving.up2, serving.hr))
        serving.net = self.net

    @staticmethod
    def nchw(conv):
        return conv.weight.contiguous(memory_format=torch.channels_last), conv.bias.to(conv.weight.dtype)

    def c(self, x, p):
        self.convs += 1
        return F.conv2d(x, p[0], p[1], padding=1)

    def cat(self, feats):
        if len(feats) == 1:
            return feats[0]
        out = torch.cat(feats, 1)
        self.glue_bytes += out.numel() * out.element_size()
        return out

    def rdb(self, x, convs):
        feats = [x]
        for p in convs[:4]:
            feats.append(F.leaky_relu(self.c(self.cat(feats), p), SLOPE, inplace=True))
        return torch.add(x, self.c(self.cat(feats), convs[4]), alpha=RES)

    def net(self, x):
        f0 = self.s._c(x, self.s.first)
        body = f0
        for rdbs in self.rrdbs:
            y = body
            for convs in rdbs:
                y = self.rdb(y, convs)
            body = torch.add(body, y, alpha=RES)
        f = f0 + self.c(body, self.conv_body)
        for p in (self.up1, self.up2):
            f = F.leaky_relu(self.c(F.interpolate(f, scale_factor=2, mode="nearest"), p), SLOPE, inplace=True)
        f = F.leaky_relu(self.c(f, self.hr), SLOPE, inplace=True)
        return self.s._c(f, self.s.last)


FORMS = ("kernel", "cat")
# ", last bias fp32": the form's output plus conv_last's bias as fp16 loses it
# (0.8 → 0.7998 on the seeded weights: every output 0.05 LSB low), the one
# rounding both forms share that moves every output the same way
LAST_BIAS = ", last bias fp32"
CHECK_FORMS = ("kernel", "plain", "cat", "kernel" + LAST_BIAS, "cat" + LAST_BIAS)
WITNESS_HW, WITNESS_SEEDS, WITNESS_FRAMES = (180, 320), 3, 2


def serving_in(form: str, cfg: dict, dev):
    """The serving graph of the configuration's sizes and weights in `form`
    (`"plain"`: every `rrdb_conv` call on `rrdb_conv_plain`; `LAST_BIAS`
    after a form: its net's output in fp32 plus what conv_last's bias lost
    to fp16)."""
    from nu_scaler_tpu_torch.kernels import rrdb_conv_cuda as rc
    from nu_scaler_tpu_torch.models import rrdbnet

    base = form.removesuffix(LAST_BIAS)
    model = rrdbnet._load(Path(rrdbnet.esrgan_lite.weights_directory(cfg["arch"], cfg["scale"])),
                          cfg["step"], cfg["sha256"], cfg["scale"])[0]
    s = rrdbnet.RRDBServing(model, cfg["in_h"], cfg["in_w"], cfg["out_h"], cfg["out_w"], dev)
    if base == "plain":
        s._k = rc.rrdb_conv_plain
    cat = CatForm(s) if base == "cat" else None
    if form != base:
        net = s.net
        lost = (model.conv_last.bias.detach().to(dev) - s.last[1].float()).view(1, -1, 1, 1)
        s.net = lambda x: net(x).float() + lost
    return s, cat


def bound_ms(cin: int, cout: int, positions: int, extra_reads: int) -> float:
    """The least time of a conv on an H100 SXM: the larger of its operations
    at 989 TFLOP/s and its bytes at 3.35 TB/s (the prefix read once, the
    output and `extra_reads` residuals of Cout channels once each, fp16)."""
    ops = 2 * 9 * cin * cout * positions
    nbytes = 2 * positions * (cin + cout * (1 + extra_reads))
    return max(ops / 989e12, nbytes / 3.35e12) * 1e3


def forms(cfg: dict, dev) -> None:
    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.kernels import rrdb_conv_cuda as rc
    from nu_scaler_tpu_torch.models import rrdbnet

    model = rrdbnet.RRDBNet(**rrdbnet.X2PLUS)
    model.body = model.body[:1]
    h, w = cfg["in_h"] // 2, cfg["in_w"] // 2
    g = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn(1, h, w, 64, generator=g, device=dev).to(torch.float16)
    s = rrdbnet.RRDBServing(model, 2, 2, 4, 4, dev)
    convs = s.rrdbs[0][0]
    buf, nxt = (rc.blocked(1, h, w, 192, torch.float16, dev).zero_() for _ in range(2))
    rc.to_blocked(x0, out=rc.channel_slice(buf, 0, 64))

    def blocked_randn(hh, ww):
        return rc.to_blocked(torch.randn(1, hh, ww, 64, generator=g, device=dev).to(torch.float16))

    cat = CatForm(s)
    x_cl = x0.permute(0, 3, 1, 2)
    for form, run in (("kernel", lambda: s.rdb(buf, convs, rc.channel_slice(nxt, 0, 64))),
                      ("cat", lambda: cat.rdb(x_cl, cat.rrdbs[0][0]))):
        emit(phase="forms", form=form, rdb_ms=time_ms(run))
    if "rrdb_conv" not in _build.BUILD_LOGS:  # built by another process: build again for ptxas's report
        _build.build(["rrdb_conv"], force=True)
    emit(phase="forms", ptxas=[ln for ln in _build.BUILD_LOGS["rrdb_conv"].splitlines()
                               if "registers" in ln or "spill" in ln])

    def one(name, conv, src, out, hw, extra, **epi):
        """The conv on its operands as served: blocked, but conv_body's
        residual f0 and conv_hr's output NHWC."""
        positions = hw[0] * hw[1]
        cin, cout = conv.cin, conv.cout
        xin = rc.to_nhwc(rc.channel_slice(src, 0, cin)).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wt, b = CatForm.nchw(conv)
        lib = time_ms(lambda: F.conv2d(xin, wt, b, padding=1))
        lib_lrelu = time_ms(lambda: F.leaky_relu(F.conv2d(xin, wt, b, padding=1), SLOPE, inplace=True))
        emit(phase="forms", conv=name, cin=cin, cout=cout, h=hw[0], w=hw[1],
             kernel_ms=time_ms(lambda: rc.rrdb_conv(src, conv, out, **epi)),
             plain_ms=time_ms(lambda: rc.rrdb_conv_plain(src, conv, out, **epi), iters=3, warm=1),
             library_ms=lib, library_lrelu_ms=lib_lrelu,
             bound_ms=bound_ms(cin, cout, positions, extra))

    for k, conv in enumerate(convs[:4]):
        one(f"conv{k + 1}", conv, buf, rc.channel_slice(buf, 64 + 32 * k, 96 + 32 * k), (h, w), 0, slope=SLOPE)
    x, y = rc.channel_slice(buf, 0, 64), rc.channel_slice(nxt, 0, 64)
    one("conv5", convs[4], buf, y, (h, w), 0, res=x, res_scale=RES)
    one("conv5_rrdb", convs[4], buf, y, (h, w), 1, res=x, res_scale=RES, res2=y, res2_scale=RES)
    f = blocked_randn(h, w)
    one("conv_body", s.conv_body, f, rc.blocked(1, h, w, 64, torch.float16, dev), (h, w), 1, res=x0)
    for name, (uh, uw) in (("conv_up1", (2 * h, 2 * w)), ("conv_up2", (4 * h, 4 * w)), ("conv_hr", (4 * h, 4 * w))):
        u = blocked_randn(uh, uw)
        out = (torch.empty(1, uh, uw, 64, dtype=torch.float16, device=dev) if name == "conv_hr"
               else rc.blocked(1, uh, uw, 64, torch.float16, dev))
        one(name, getattr(s, {"conv_up1": "up1", "conv_up2": "up2", "conv_hr": "hr"}[name]), u, out, (uh, uw), 0,
            slope=SLOPE)
        del u, out


def frames_phase(cfg: dict, dev) -> None:
    from nu_scaler_tpu_torch.models import rrdbnet

    serve_dir(cfg)
    clip = frames.make_clip(registry.traffic("yuv420_link"), cfg["in_h"], cfg["in_w"], 7)
    img = torch.from_numpy(clip[0]).to(dev)[None]
    for form in FORMS:
        s, cat = serving_in(form, cfg, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = time_ms(lambda: s(img), iters=8, warm=2)
        rrdbnet.reset_launches()
        if cat is not None:
            cat.glue_bytes = cat.convs = 0
        out = s(img)
        torch.cuda.synchronize()
        emit(phase="frames", form=form, frame_ms=ms, memory_peak_bytes=torch.cuda.max_memory_allocated(dev),
             glue_bytes=0 if cat is None else cat.glue_bytes,
             launches=dict(rrdbnet.launches) if cat is None else {"conv": cat.convs + 2},
             out_sha=hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16])
        del s, cat
        torch.cuda.empty_cache()


def stages(cfg: dict, dev) -> None:
    from torch.profiler import ProfilerActivity, profile, record_function

    from nu_scaler_tpu_torch.models import rrdbnet
    from nu_scaler_tpu_torch.utils import tracing

    serve_dir(cfg)
    clip = frames.make_clip(registry.traffic("yuv420_link"), cfg["in_h"], cfg["in_w"], 7)
    img = torch.from_numpy(clip[0]).to(dev)[None]
    up = rrdbnet.make_upscaler(cfg["in_h"], cfg["in_w"], cfg["out_h"], cfg["out_w"], dev)
    for _ in range(2):
        up.serving(img)
    torch.cuda.synchronize()
    n = 2
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(n):
                up.serving(img)
            torch.cuda.synchronize()
    tracing.disable()
    tracing.drain()
    path = Path(tempfile.mkdtemp()) / "trace.json"
    prof.export_chrome_trace(str(path))
    trace.SPAN_PREFIX = "nu.models.rrdb"
    rec = trace.reduce(trace.load_events(path), n, n)
    by_name: dict = {}
    for o in rec["ops"]:
        k = by_name.setdefault(o["name"][:160], [0, 0.0, o["cat"]])
        k[0] += 1
        k[1] += o["dur"]
    emit(phase="stages", frames=n, window_ms=rec["window_us"] / 1e3,
         busy_ms=rec["busy_us"] / 1e3, ops_per_frame=len(rec["ops"]) / n,
         device_ms_by_stage=stage_events(up, img))
    for name, (cnt, us, cat) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        emit(phase="stages", op=name, cat=cat, per_frame=cnt / n, ms_per_frame=us / 1e3 / n)


def stage_events(up, img, frames_n: int = 3) -> dict:
    """Device ms a frame by ``nu.models.rrdb.*`` stage, from a CUDA event
    pair around each span (one stream: the pair spans the stage's work, the
    host well ahead of the card)."""
    import contextlib

    from nu_scaler_tpu_torch.models import rrdbnet

    pairs: list = []

    @contextlib.contextmanager
    def timed(name, **attrs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        pairs.append((name, a, b))

    old = rrdbnet.span
    rrdbnet.span = timed
    try:
        for _ in range(frames_n):
            up.serving(img)
        torch.cuda.synchronize()
    finally:
        rrdbnet.span = old
    out: dict = {}
    for name, a, b in pairs:
        out[name] = out.get(name, 0.0) + a.elapsed_time(b) / frames_n
    return out


def compare(lref, inputs, ups, fn) -> tuple[int, float]:
    """(max |d| in LSB, % of bytes differing) of `fn`'s upscales of `inputs`
    against `ups`, through the 4:2:0 delivery."""
    worst = differ = total = 0
    for i, want in zip(inputs, ups):
        got = fn(lref.ingest(i))
        for p, q in zip(lref.deliver(got), lref.deliver(want)):
            d = (p.to(torch.int16) - q.to(torch.int16)).abs()
            worst = max(worst, int(d.max()))
            differ += int((d != 0).sum())
            total += d.numel()
    return worst, 100 * differ / total


def check(cfg: dict, dev, seeds: list, n_frames: int) -> None:
    serve_dir(cfg)
    mix = registry.traffic("yuv420_link")
    lref = yuv420.Reference(dev)
    ref = bref.Reference(cfg, dev)
    servings = {form: serving_in(form, cfg, dev)[0] for form in CHECK_FORMS}
    for k, seed in enumerate(seeds):
        inputs = yuv420.host_inputs(frames.make_clip(mix, cfg["in_h"], cfg["in_w"], seed)[:n_frames])
        t = time.perf_counter()
        ups = [ref.upscale(lref.ingest(i)) for i in inputs]
        torch.cuda.synchronize()
        if k == 0:
            emit(phase="check", reference_s_per_frame=(time.perf_counter() - t) / len(inputs))
            o = torch.stack(ups)[..., :3].float()
            emit(phase="check", out_std_lsb=float(o.std()), out_mean=float(o.mean()),
                 clamped_pct=100 * float(((o == 0) | (o == 255)).float().mean()))
            del o
        sides = {f"program {form}": (lambda img, s=s: s(img[None])[0]) for form, s in servings.items()}
        if k == 0:
            sides["control bf16"] = bref.Reference(cfg, dev, control=True).upscale
            for fault in bref.FAULTS:
                sides[f"fault {fault}"] = bref.Reference(cfg, dev, fault=fault).upscale
        for name, fn in sides.items():
            worst, pct = compare(lref, inputs, ups, fn)
            emit(phase="check", seed=seed, frames=len(inputs), side=name, max_abs_lsb=worst, mismatch_pct=pct)
        del ups, sides


def exact(src, conv, epi: dict) -> torch.Tensor:
    """The conv of ``src[..., :conv.cin]`` (its fp16 values) in fp64, nine
    tap matmuls, then the bias and the epilogue in fp64: the value the
    kernel and the plain version each round once to fp16."""
    from nu_scaler_tpu_torch.kernels import rrdb_conv_cuda as rc

    n, h, w = src.shape[:3]
    x = F.pad(src[..., :conv.cin].double(), (0, 0, 1, 1, 1, 1))
    k = conv.weight.double().permute(2, 3, 1, 0)
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = x[:, dy:dy + h, dx:dx + w, :].reshape(-1, conv.cin) @ k[dy, dx]
            acc = tap if acc is None else acc.add_(tap)
    del x
    v = acc.reshape(n, h, w, -1) + conv.bias.double()
    res, res2 = epi.get("res"), epi.get("res2")
    return rc.epilogue(v, epi.get("slope"), None if res is None else res.double(), epi.get("res_scale", 1.0),
                       None if res2 is None else res2.double(), epi.get("res2_scale", 1.0))


def rounding(got: torch.Tensor, e: torch.Tensor) -> dict:
    """`got` (fp16) against the exact `e` (fp64): the % of values not equal
    to `e` rounded to fp16, and the mean and largest signed error in fp16
    ulps of `e`, positive towards larger magnitude."""
    from nu_scaler_tpu_torch.kernels import rrdb_conv_cuda as rc

    ulp = rc.ulp_fp16(e).double()
    err = (got.double() - e) * torch.sign(e) / ulp
    return {"wrong_pct": 100 * float((got != e.to(torch.float16)).double().mean()),
            "mean_err_ulp": float(err.mean()), "max_abs_err_ulp": float(err.abs().max())}


def sums(cfg: dict, dev) -> None:
    from nu_scaler_tpu_torch.kernels import rrdb_conv_cuda as rc

    h, w = cfg["in_h"] // 2, cfg["in_w"] // 2
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.float16)

    def conv(cin, cout, bias=True):
        k = torch.randn(cout, cin, 3, 3, generator=g, device=dev) * (2.0 / (9 * cin)) ** 0.5
        b = torch.randn(cout, generator=g, device=dev) * 0.1 if bias else torch.zeros(cout, device=dev)
        return rc.make_conv(k, b, dev, torch.float16)

    buf, nxt, f0 = randn(1, h, w, 192), randn(1, h, w, 192), randn(1, h, w, 64)
    c5 = conv(192, 64)
    # name: (src, conv, epilogue); each writes a tensor of its own
    cases = {f"conv{k + 1}": (buf, conv(64 + 32 * k, 32), dict(slope=SLOPE)) for k in range(4)}
    cases["conv5"] = (buf, c5, dict(res=buf[..., :64], res_scale=RES))
    cases["conv5_rrdb"] = (buf, c5, dict(res=buf[..., :64], res_scale=RES, res2=nxt[..., :64], res2_scale=RES))
    cases["conv_body"] = (randn(1, h, w, 64), conv(64, 64), dict(res=f0))
    cases["conv_up2"] = (randn(1, 4 * h, 4 * w, 64), conv(64, 64), dict(slope=SLOPE))
    for name, (src, cv, epi) in cases.items():
        e = exact(src, cv, epi)
        got = rc.rrdb_conv(src, cv, torch.empty(e.shape, dtype=torch.float16, device=dev), **epi)
        plain = rc.rrdb_conv_plain(src, cv, torch.empty_like(got), **epi)
        tol = rc.ulp_tolerance(src, cv, plain.float(), epi.get("res_scale", 1.0), epi.get("res2_scale", 1.0))
        d = (got.float() - plain.float()).abs()
        emit(phase="sums", conv=name, cin=cv.cin, cout=cv.cout, h=src.shape[1], w=src.shape[2],
             kernel=rounding(got, e), plain=rounding(plain, e),
             kernel_vs_plain={"differ_pct": 100 * float((got != plain).float().mean()),
                              "max_of_tolerance": float((d / tol).max()),
                              "over_tolerance": int((d > tol).sum()),
                              "max_ulp": float((d / rc.ulp_fp16(plain)).max())})
        del e, got, plain, tol, d
    # the bare sums: zero bias, the LeakyReLU instance, its positive outputs
    for name, cin, cout in (("conv1", 64, 32), ("conv5", 192, 64)):
        cv = conv(cin, cout, bias=False)
        e = exact(buf, cv, {})
        pos = e > 0
        got = rc.rrdb_conv(buf, cv, torch.empty(e.shape, dtype=torch.float16, device=dev), slope=SLOPE)
        plain = rc.rrdb_conv_plain(buf, cv, torch.empty_like(got), slope=SLOPE)
        xc = buf[..., :cin].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        lib = F.conv2d(xc, cv.weight.contiguous(memory_format=torch.channels_last), padding=1).permute(0, 2, 3, 1)
        emit(phase="sums", bare_sums=name, cin=cin, cout=cout, positive_pct=100 * float(pos.double().mean()),
             **{side: rounding(t[pos], e[pos]) for side, t in (("kernel", got), ("plain", plain), ("cudnn", lib))})
        del e, pos, got, plain, xc, lib


def witness(cfg: dict, dev, seed: int, step: int, directory: Path) -> None:
    small = dict(cfg, in_h=WITNESS_HW[0], in_w=WITNESS_HW[1], out_h=2 * WITNESS_HW[0], out_w=2 * WITNESS_HW[1])
    serve_dir(small)
    mix = registry.traffic("yuv420_link")
    lref = yuv420.Reference(dev)
    ref = bref.Reference(small, dev)
    forms = ("kernel", "plain") if dev.type == "cuda" else ("plain",)
    servings = {form: serving_in(form, small, dev)[0] for form in forms}
    directory.mkdir(parents=True, exist_ok=True)
    for seed_k in (seed + k * step for k in range(WITNESS_SEEDS)):
        clip = frames.make_clip(mix, small["in_h"], small["in_w"], seed_k)[:WITNESS_FRAMES]
        inputs = yuv420.host_inputs(clip)
        ups = [ref.upscale(lref.ingest(i)) for i in inputs]
        for form, s in servings.items():
            outs = [s(lref.ingest(i)[None])[0] for i in inputs]
            worst, pct = compare(lref, inputs, ups, lambda img, it=iter(outs): next(it))
            emit(phase="witness", device=dev.type, seed=seed_k, form=form, max_abs_lsb=worst, mismatch_pct=pct)
            planes = [p.cpu() for o in outs for p in lref.deliver(o)]
            if dev.type == "cuda":
                torch.save(planes, directory / f"card_{form}_{seed_k}.pt")
                continue
            for card_form in ("kernel", "plain"):
                path = directory / f"card_{card_form}_{seed_k}.pt"
                if not path.is_file():
                    continue
                diff = [(a.to(torch.int16) - b.to(torch.int16)).abs() for a, b in zip(planes, torch.load(path))]
                emit(phase="witness", seed=seed_k, cpu=form, card=card_form,
                     max_abs_lsb=max(int(d.max()) for d in diff),
                     differ_pct=100 * sum(int((d != 0).sum()) for d in diff) / sum(d.numel() for d in diff))


def tail(cfg: dict, dev, seed: int, n_frames: int) -> None:
    from nu_scaler_tpu_torch.models import rrdbnet

    serve_dir(cfg)
    mix = registry.traffic("yuv420_link")
    lref = yuv420.Reference(dev)
    ref = bref.Reference(cfg, dev)
    up = rrdbnet.make_upscaler(cfg["in_h"], cfg["in_w"], cfg["out_h"], cfg["out_w"], dev)
    yuv = torch.zeros(256, dtype=torch.int64)
    rgb = torch.zeros(256, dtype=torch.int64)
    worst = []
    for k in range(-(-n_frames // 6)):
        for host in yuv420.host_inputs(frames.make_clip(mix, cfg["in_h"], cfg["in_w"], seed + k)):
            img = lref.ingest(host)
            want, got = ref.upscale(img), up(img)
            d = (got[..., :3].to(torch.int16) - want[..., :3].to(torch.int16)).abs()
            rgb += torch.bincount(d.flatten().long(), minlength=256).cpu()
            most = 0
            for p, q in zip(lref.deliver(got), lref.deliver(want)):
                d = (p.to(torch.int16) - q.to(torch.int16)).abs()
                yuv += torch.bincount(d.flatten().long(), minlength=256).cpu()
                most = max(most, int(d.max()))
            worst.append(most)
    emit(phase="tail", frames=len(worst), max_by_frame=worst,
         yuv420_bytes_by_lsb={i: int(c) for i, c in enumerate(yuv.tolist()) if c},
         rgb_bytes_by_lsb={i: int(c) for i, c in enumerate(rgb.tolist()) if c})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phase", default="forms,frames,stages,check,tail")
    p.add_argument("--seed", type=int, default=2**31 + 404)
    p.add_argument("--seeds", type=int, default=1, help="check: seeds, --seed-step apart")
    p.add_argument("--seed-step", type=int, default=97)
    p.add_argument("--check-frames", type=int, default=2, help="check: frames of each seed's clip")
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--witness", type=Path, default=ROOT / "chiprun_out" / "rrdb_witness")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cpu":
        if args.phase != "witness":
            raise SystemExit("--device cpu runs the witness phase alone")
        witness(registry.config(CONFIG), torch.device("cpu"), args.seed, args.seed_step, args.witness)
        return 0
    if not torch.cuda.is_available():
        print("rrdb_probe: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cfg = registry.config(CONFIG)
    emit(card=card_name(), torch=torch.__version__, cuda=torch.version.cuda,
         cudnn=torch.backends.cudnn.version())
    t0 = time.perf_counter()
    for phase in args.phase.split(","):
        t = time.perf_counter()
        if phase == "forms":
            forms(cfg, dev)
        elif phase == "frames":
            frames_phase(cfg, dev)
        elif phase == "stages":
            stages(cfg, dev)
        elif phase == "check":
            check(cfg, dev, [args.seed + k * args.seed_step for k in range(args.seeds)], args.check_frames)
        elif phase == "sums":
            sums(cfg, dev)
        elif phase == "witness":
            witness(cfg, dev, args.seed, args.seed_step, args.witness)
        elif phase == "tail":
            tail(cfg, dev, args.seed, args.frames)
        else:
            raise SystemExit(f"unknown phase {phase!r}")
        emit(phase_done=phase, seconds=time.perf_counter() - t)
    emit(done=True, seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
