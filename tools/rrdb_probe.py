"""Time and check Real-ESRGAN's RRDBNet ×2 (`models/rrdbnet.py`) on an NVIDIA
card at 1080p → 4K, with the seeded weights of the benchmark's
configuration `realesrgan_x2plus_fp16`.

Run from the root of a checkout, on a machine with a card:

    python3 tools/rrdb_probe.py [--phase forms,frames,stages,check,tail] [--seed N] [--frames N]

Phases (each prints JSON lines, the last line of all a summary):

- ``forms``: one RDB at 540×960 in fp16 in each of three forms of its dense
  connections (`FORMS`: the served concatenation, and growth buffers in
  NCHW and channels-last, `GrowthBuffer`), with cuDNN's autotuner off and on, and the
  RDB's convs alone at their real widths, each the median of 20 CUDA-event
  timings after 3 warm-ups;
- ``frames``: the whole serving graph (u8 RGBA in, u8 RGBA out) in each
  form, the median of 8 frames, the memory peak, and the bytes the
  concatenations write (`rrdbnet.glue_bytes`);
- ``stages``: device ms a frame by ``nu.models.rrdb.*`` stage (a CUDA
  event pair around each of the program's spans), and two profiled frames:
  the device operations by name, and their count;
- ``check``: two frames of the 4:2:0 traffic through the program (each
  form), the
  benchmark's fp32 reference, its bf16 control and each planted fault (in
  fp16), compared through the 4:2:0 delivery as the benchmark compares
  them, and the output's spread and clamped share;
- ``tail``: the program against the fp32 reference on `--frames` frames of
  the traffic (6 a seed from `--seed` on), the 4:2:0 payload's bytes
  counted by their difference in LSB, and the RGB bytes' too.

Exits non-zero without a card.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import frames, registry, trace  # noqa: E402
from portbench.links import yuv420  # noqa: E402
from portbench.reference import rrdbnet as bref  # noqa: E402

CONFIG = "realesrgan_x2plus_fp16"


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


class GrowthBuffer:
    """The serving graph with its dense connections on growth buffers, for
    timing against the served form: one buffer of ``num_feat + 4·grow``
    channels per RDB, each LeakyReLU writing its 32 channels into their
    slice, each conv reading a channel prefix in place, in memory format
    `fmt` (NCHW: a prefix of one frame is contiguous; channels-last: cuDNN
    copies it)."""

    def __init__(self, serving, fmt) -> None:
        self.s, self.fmt = serving, fmt
        conv = lambda p: (p[0].contiguous(memory_format=fmt), p[1])  # noqa: E731
        s = serving
        s.first, s.conv_body, s.up1, s.up2, s.hr, s.last = (
            conv(p) for p in (s.first, s.conv_body, s.up1, s.up2, s.hr, s.last))
        s.rrdbs = [[[conv(p) for p in convs] for convs in rdbs] for rdbs in s.rrdbs]
        self.c, self.g = s.first[0].shape[0], s.rrdbs[0][0][0][0].shape[0]
        prepare = s.prepare
        s.prepare = lambda img: prepare(img).contiguous(memory_format=fmt)
        s.body = self.body

    def rdb(self, buf, convs, out):
        """One RDB on `buf`, whose first channels hold its input; its output
        written into `out` (a new tensor when None)."""
        from nu_scaler_tpu_torch.models import rrdbnet

        c, g = self.c, self.g
        for k, p in enumerate(convs[:4]):
            lo = c + k * g
            torch.ops.aten.leaky_relu.out(self.s._c(buf[:, :lo], p), rrdbnet.SLOPE, out=buf[:, lo:lo + g])
        x5 = self.s._c(buf, convs[4])
        if out is None:
            return torch.add(buf[:, :c], x5, alpha=rrdbnet.RES)
        return torch.add(buf[:, :c], x5, alpha=rrdbnet.RES, out=out)

    def body(self, f0):
        from nu_scaler_tpu_torch.models import rrdbnet

        n, c, h, w = f0.shape
        a, b, cc = (torch.empty((n, c + 4 * self.g, h, w), dtype=f0.dtype, device=f0.device,
                                memory_format=self.fmt) for _ in range(3))
        a[:, :c].copy_(f0)
        for rdbs in self.s.rrdbs:  # a[:, :c] holds the RRDB's input; each RDB writes the next one's
            self.rdb(a, rdbs[0], b[:, :c])
            self.rdb(b, rdbs[1], cc[:, :c])
            y = self.rdb(cc, rdbs[2], None)
            torch.add(a[:, :c], y, alpha=rrdbnet.RES, out=b[:, :c])
            a, b, cc = b, cc, a
        return a[:, :c]


FORMS = {"cat": None, "buffer": torch.contiguous_format, "buffer_cl": torch.channels_last}


def serving_in(form: str, cfg: dict, dev):
    """The serving graph of the configuration's sizes and weights in `form`."""
    from nu_scaler_tpu_torch.models import rrdbnet

    model = rrdbnet._load(Path(rrdbnet.esrgan_lite.weights_directory(cfg["arch"], cfg["scale"])),
                          cfg["step"], cfg["sha256"], cfg["scale"])[0]
    s = rrdbnet.RRDBServing(model, cfg["in_h"], cfg["in_w"], cfg["out_h"], cfg["out_w"], dev)
    if FORMS[form] is not None:
        GrowthBuffer(s, FORMS[form])
    return s


def forms(cfg: dict, dev) -> None:
    from nu_scaler_tpu_torch.models import rrdbnet

    model = rrdbnet.RRDBNet(**rrdbnet.X2PLUS)
    model.body = model.body[:1]
    h, w = cfg["in_h"] // 2, cfg["in_w"] // 2
    g = torch.Generator(device="cpu").manual_seed(1)
    x0 = torch.randn(1, 64, h, w, generator=g).to(dev, torch.float16)
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for form, fmt in FORMS.items():
            s = rrdbnet.RRDBServing(model, 2, 2, 4, 4, dev)
            rrdbnet.reset_launches()
            if fmt is None:
                convs, x = s.rrdbs[0][0], x0.contiguous(memory_format=torch.channels_last)
                run = lambda: s.rdb(x, convs)  # noqa: E731
            else:
                gb = GrowthBuffer(s, fmt)
                convs = s.rrdbs[0][0]
                buf = torch.empty(1, 192, h, w, device=dev, dtype=torch.float16, memory_format=fmt).zero_()
                buf[:, :64].copy_(x0)
                run = lambda: gb.rdb(buf, convs, None)  # noqa: E731
            run()
            glue, convs_n = rrdbnet.glue_bytes, rrdbnet.launches["conv"]
            emit(phase="forms", form=form, cudnn_benchmark=bench, rdb_ms=time_ms(run),
                 glue_bytes=glue, convs=convs_n)
        # the five convs alone on fresh contiguous inputs, in each layout
        for fmt_name, fmt in (("channels_last", torch.channels_last), ("nchw", torch.contiguous_format)):
            total = 0.0
            for k, (wt, b) in enumerate(rrdbnet.RRDBServing(model, 2, 2, 4, 4, dev).rrdbs[0][0]):
                cin = wt.shape[1]
                xi = torch.randn(1, cin, h, w, generator=g).to(dev, torch.float16).contiguous(memory_format=fmt)
                wk = wt.contiguous(memory_format=fmt)
                ms = time_ms(lambda: torch.nn.functional.conv2d(xi, wk, b, padding=1))
                total += ms
                ops = 2 * 9 * cin * wt.shape[0] * h * w
                emit(phase="forms", conv=k + 1, layout=fmt_name, cudnn_benchmark=bench, ms=ms,
                     tflops=ops / ms / 1e9)
            emit(phase="forms", convs_alone_ms=total, layout=fmt_name, cudnn_benchmark=bench)
    torch.backends.cudnn.benchmark = False


def frames_phase(cfg: dict, dev) -> None:
    from nu_scaler_tpu_torch.models import rrdbnet

    serve_dir(cfg)
    clip = frames.make_clip(registry.traffic("yuv420_link"), cfg["in_h"], cfg["in_w"], 7)
    img = torch.from_numpy(clip[0]).to(dev)[None]
    for form in FORMS:
        s = serving_in(form, cfg, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = time_ms(lambda: s(img), iters=8, warm=2)
        rrdbnet.reset_launches()
        out = s(img)
        torch.cuda.synchronize()
        emit(phase="frames", form=form, frame_ms=ms, memory_peak_bytes=torch.cuda.max_memory_allocated(dev),
             glue_bytes=rrdbnet.glue_bytes, convs=rrdbnet.launches["conv"],
             out_sha=hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16])
        del s
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


def check(cfg: dict, dev, seed: int) -> None:
    from nu_scaler_tpu_torch.models import rrdbnet

    serve_dir(cfg)
    mix = registry.traffic("yuv420_link")
    clip = frames.make_clip(mix, cfg["in_h"], cfg["in_w"], seed)[:2]
    lref = yuv420.Reference(dev)
    inputs = yuv420.host_inputs(clip)
    ref = bref.Reference(cfg, dev)
    t = time.perf_counter()
    ups = [ref.upscale(lref.ingest(i)) for i in inputs]
    torch.cuda.synchronize()
    emit(phase="check", reference_s_per_frame=(time.perf_counter() - t) / len(inputs))
    o = torch.stack(ups)[..., :3].float()
    emit(phase="check", out_std_lsb=float(o.std()), out_mean=float(o.mean()),
         clamped_pct=100 * float(((o == 0) | (o == 255)).float().mean()))
    del o

    def cmp(name, fn):
        worst = differ = total = 0
        for i, want in zip(inputs, ups):
            got = fn(lref.ingest(i))
            for p, q in zip(lref.deliver(got), lref.deliver(want)):
                d = (p.to(torch.int16) - q.to(torch.int16)).abs()
                worst = max(worst, int(d.max()))
                differ += int((d != 0).sum())
                total += d.numel()
        emit(phase="check", side=name, max_abs_lsb=worst, mismatch_pct=100 * differ / total)

    for form in FORMS:
        s = serving_in(form, cfg, dev)
        cmp(f"program {form}", lambda img: s(img[None])[0])
    cmp("control bf16", bref.Reference(cfg, dev, control=True).upscale)
    for fault in bref.FAULTS:
        cmp(f"fault {fault}", bref.Reference(cfg, dev, fault=fault).upscale)


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
    p.add_argument("--frames", type=int, default=36)
    args = p.parse_args(argv)
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
            check(cfg, dev, args.seed)
        elif phase == "tail":
            tail(cfg, dev, args.seed, args.frames)
        else:
            raise SystemExit(f"unknown phase {phase!r}")
        emit(phase_done=phase, seconds=time.perf_counter() - t)
    emit(done=True, seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
