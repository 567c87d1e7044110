#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (nu_scaler_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printed on its own line with its seconds:

1. the card: its name, and its power limit as nvidia-smi reports it;
2. the build: one nvcc call per source under nu_scaler_tpu_torch/kernels/csrc/
   (resample_fused.cu, soft_warp.cu), all started together, into
   build/nu_scaler_tpu_torch/;
3. each kernel wrapper against its plain PyTorch version on the card, at
   1080p→4K: lanczos3, bilinear and nearest single frames (nearest bit-exact,
   the others ≤1 LSB), a batch of 4, and the blend epilogue with t = 0.5 and
   t = (1/3, 2/3); the soft warp at 1080p (≤1 LSB) with K = 4 and 8,
   t = 0.5 and (1/3, 2/3), tiles (8, 128) and (8, 32), on the bench pair
   (its flow tiles) and on a noise pair with random tile motion;
4. the main path through the entry points a user calls: PyWgpuUpscaler
   upscale / upscale_batch (lanczos3, ≥50 dB against the float64 golden),
   WgpuFrameInterpolator.interpolate_py (blend) and the fused LivePipeline
   over 8 frames (15 output frames; mid ≥50 dB against the blend of the two
   goldens). The launch counts must show that every kernel ran. Then, on the
   host clock, the latency of upscale(bytes) and the live pipeline's output
   frames per second, with outputs left on the card and fetched to the host.
   Then the flow_soft path, its launch counts read on their own:
   WgpuFrameInterpolator(mode="flow_soft") interpolate_py and
   interpolate_multi_py, and a LivePipeline of 8 frames with a lanczos3
   upscale and the flow_soft interpolator (1 soft_warp_blend and 2
   resample_fused launches per step); the mids against the plain version's
   mids on the same tiles (≥50 dB RGB), the flow tiles on the card against
   the CPU (≤1e-2 px), and on the host clock and CUDA events the
   interpolate_py latency, the live output fps and the per-step split;
5. times: per kernel the median of 20 CUDA-event timings after 3 warm-ups,
   the plain version's time, and the bound (the larger of bytes moved over
   the memory rate and fp32 operations over the fp32 rate);
6. torch.profiler traces of 7 fused live steps and of 7 flow_soft live
   steps: the device's busy share, kernel launches per step and device time
   by kernel and copy.

The line before the last is the card's name and power limit; the one before
that is the kernels' JSON; the last line is the result JSON. Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

IN_H, IN_W, OUT_H, OUT_W = 1080, 1920, 2160, 3840
SEED = 0
PSNR_GATE_DB = 50.0  # the JAX side's lanczos3 and blend gates
LIVE_FRAMES = 8
BATCH = 4
SOURCE = "nu_scaler_tpu_torch/kernels/csrc/resample_fused.cu"
SOFT_SOURCE = "nu_scaler_tpu_torch/kernels/csrc/soft_warp.cu"
REPLACES = {
    "resample_fused": "nu_scaler_tpu/kernels/resample_pallas.py:268",
    "resample_fused_batched": "nu_scaler_tpu/kernels/resample_pallas.py:139",
    "resample_fused_blend": "nu_scaler_tpu/kernels/resample_pallas.py:371",
    "soft_warp_blend": "nu_scaler_tpu/kernels/soft_warp_pallas.py:984",
}
SOFT_TILES = ((8, 128), (8, 32))  # the default preset's warp tile, and "tall"'s at 1080p
FLOW_TILE_GATE_PX = 1e-2  # flow tiles, card vs CPU
SPLIT_STEPS = 10
# Published peaks (NVIDIA data sheets): device memory bytes/s, fp32 FLOP/s
# outside the tensor cores. The H100 SXM row is the default.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}
T_START = time.perf_counter()


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        secs = time.perf_counter() - self.t0
        say(f"phase {self.name}: {'ok' if exc is None else 'FAILED'} in {secs:.2f} s")
        return False


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gradient_pattern(width: int, height: int) -> np.ndarray:
    """The reference benchmark's test pattern (a copy of tests/conftest.py's)."""
    x = np.arange(width, dtype=np.uint64)
    y = np.arange(height, dtype=np.uint64)
    img = np.empty((height, width, 4), dtype=np.uint8)
    img[..., 0] = (x * 255 // width).astype(np.uint8)[None, :]
    img[..., 1] = (y * 255 // height).astype(np.uint8)[:, None]
    img[..., 2] = ((x[None, :] + y[:, None]) * 255 // (width + height)).astype(np.uint8)
    img[..., 3] = 255
    return img


def wave_pattern(width: int, height: int, shift: float) -> np.ndarray:
    """Smooth sinusoidal texture moved right by `shift` columns: a pair whose
    true middle frame is known, and where a cross-fade is visibly wrong."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.empty((height, width, 4), dtype=np.uint8)
    for c in range(3):
        img[..., c] = np.clip(127.5 + 60.0 * np.sin(2 * np.pi * (x - shift) / 60.0 + c)
                              + 40.0 * np.sin(2 * np.pi * y / 44.0 + 2 * c), 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def make_frames(rng) -> dict:
    """Frame a is the bench input (gradient + white box); b is a rolled by 16
    columns; n1, n2 are seeded noise, the hardest case for 1-LSB parity."""
    a = gradient_pattern(IN_W, IN_H)
    a[480:600, 640:760, :3] = 255
    return {
        "a": a,
        "b": np.roll(a, 16, axis=1),
        "n1": rng.integers(0, 256, (IN_H, IN_W, 4), np.uint8),
        "n2": rng.integers(0, 256, (IN_H, IN_W, 4), np.uint8),
    }


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR over RGB (alpha excluded), as nu_scaler's ErrorMetrics."""
    d = a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse <= 0.0 else 20.0 * np.log10(255.0 / np.sqrt(mse))


def diff_stats(x, y) -> tuple[int, float]:
    """(max |x − y| in LSB, share of exactly equal values) of two u8 tensors."""
    import torch

    d = (x.to(torch.int16) - y.to(torch.int16)).abs()
    return int(d.max().item()), float((d == 0).double().mean().item())


def golden(torch, frame: np.ndarray, wv, wh):
    """Float64 golden on the card: dense BLAS matmuls on u8/255, then the WGSL
    trunc pack of nu_scaler_tpu_torch.kernels.reference.pack_u8_trunc."""
    f = torch.from_numpy(frame).cuda().double() / 255.0
    tmp = (wv @ f.reshape(IN_H, IN_W * 4)).reshape(OUT_H, IN_W, 4)
    tmp = tmp.permute(0, 2, 1).reshape(OUT_H * 4, IN_W)
    out = (tmp @ wh.T).reshape(OUT_H, 4, OUT_W).permute(0, 2, 1)
    return torch.trunc(torch.clamp(out.float(), 0.0, 1.0) * 255.0).to(torch.uint8)


def time_ms(torch, fn, flush) -> float:
    """Median of 20 CUDA-event timings of fn() after 3 warm-ups. Before each
    timing the L2 cache is flushed (a 256 MB write) and the stream is held
    busy, so the events see the device time and not the host's launch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def live_fps(torch, make_pipe, frames, to_host: bool) -> float:
    """Output frames per second of a live pipeline over two passes of
    `frames` (host numpy frames in), after a warm-up. to_host: every output
    frame is fetched to host memory (`put`), else it stays on the card
    (`put_device`)."""
    pipe = make_pipe()
    put = pipe.put if to_host else pipe.put_device
    drain = pipe.drain if to_host else pipe.drain_device
    for f in frames[:2]:
        put(f)
    drain()
    torch.cuda.synchronize()
    pipe.frames_out = 0
    t0 = time.perf_counter()
    for _ in range(2):
        for f in frames:
            put(f)
    drain()
    torch.cuda.synchronize()
    return pipe.frames_out / (time.perf_counter() - t0)


def device_busy(trace_path, wall_us: float) -> dict:
    """Device activity of a torch.profiler chrome trace: busy share of the
    window (the union of kernel, memcpy and memset intervals) and device time
    by name."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, by_name, n_kernels = [], {}, 0
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ev["ts"], ev["ts"] + ev["dur"]))
            by_name[ev["name"][:60]] = by_name.get(ev["name"][:60], 0.0) + ev["dur"]
            n_kernels += ev["cat"] == "kernel"
    if not spans:
        return {"device_busy_us": None, "busy_share": None,
                "note": "the profiler saw no device activity: not measured"}
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_us": busy, "busy_share": busy / wall_us if wall_us > 0 else None,
            "kernel_launches": n_kernels, "device_us_by_name": dict(top)}


def trace_steps(torch, pipe, frames, path) -> dict:
    """One profiler window over live steps (host numpy frames in, outputs left
    on the card), after a first frame outside the window."""
    from torch.profiler import ProfilerActivity, profile

    pipe.put_device(frames[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[1:]:
            pipe.put_device(f)
        pipe.drain_device()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    busy = device_busy(path, wall_us)
    steps = len(frames) - 1
    busy["wall_us_per_step"] = wall_us / steps
    if busy.get("kernel_launches") is not None:
        busy["kernel_launches_per_step"] = busy["kernel_launches"] / steps
    return busy


def soft_warp_work(torch, swc, a, tiles, t: float, tile, k: int, rng: int) -> tuple[int, int]:
    """(bytes, fp32 operations) the soft warp needs on these inputs: frames a
    and b read once, the output written once, the tile arrays read once; per
    pixel 126 operations of cell and motion mixing, accumulation and
    packing, plus 42 per distinct corner candidate of each frame (two
    fractions, three lerps on four channels), as csrc/soft_warp.cu counts
    them."""
    h, w = a.shape[0], a.shape[1]
    frames_in = swc.frame_inputs(tiles, t, k, rng)
    distinct = 0
    for corners in swc.corner_assign(frames_in, h, w, tile):
        s = torch.sort(corners, dim=0).values
        distinct += int((1 + (s[1:] != s[:-1]).sum(dim=0)).sum().item())
    n_tiles = tiles.shape[0] * tiles.shape[1]
    moved = 3 * h * w * 4 + 2 * n_tiles * (8 + 4) + 2 * 2 * k * 4
    return moved, 126 * h * w + 42 * distinct


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    from nu_scaler_tpu_torch.core import PyWgpuUpscaler, WgpuFrameInterpolator
    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.kernels import reference as ref
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc
    from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
    from nu_scaler_tpu_torch.ops import interpolate as interp
    from nu_scaler_tpu_torch.ops import resample
    from nu_scaler_tpu_torch.runtime.streaming import LivePipeline

    # plain versions and goldens in full fp32 / fp64: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("1 card"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=15,
        )
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        card = smi.stdout.strip().splitlines()[0]
        mem_bw, f32_rate = next((v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
        say(f"card: {kind} x{count}; nvidia-smi: {card}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}; peaks {mem_bw:.3g} B/s, {f32_rate:.3g} fp32 FLOP/s")

    with Phase("2 build"):
        built = _build.build()  # one nvcc per source, all started together
        for name in _build.SIGNATURES:
            _build.load_library(name)
            say(f"kernel library {_build.library_path(name).name} "
                f"({'built in %.2f s' % built[name] if name in built else 'cached'})")

    rng = np.random.default_rng(SEED)
    frames = make_frames(rng)
    dev = torch.device("cuda")
    on_dev = {k: torch.from_numpy(v).to(dev) for k, v in frames.items()}
    plans = {
        algo: resample.make_resampler(IN_H, IN_W, OUT_H, OUT_W, algo, dev).plan
        for algo in ("lanczos3", "bilinear", "nearest")
    }
    lz = plans["lanczos3"]
    errs = {name: 0 for name in REPLACES}

    with Phase("3 kernels vs plain"):
        for algo, plan in plans.items():
            for key in ("a", "n1"):
                k = rc.resample_fused(on_dev[key], plan)
                p = rc.resample_plain(on_dev[key], plan)
                torch.cuda.synchronize()
                max_d, exact = diff_stats(k, p)
                say(f"resample_fused {algo} [{key}]: max {max_d} LSB, exact {exact:.7f}")
                check(max_d <= (0 if algo == "nearest" else 1), f"resample_fused {algo}: {max_d} LSB")
                errs["resample_fused"] = max(errs["resample_fused"], max_d)
        batch = torch.stack([on_dev[k] for k in ("a", "b", "n1", "n2")])
        k = rc.resample_fused_batched(batch, lz)
        p = rc.resample_plain(batch, lz)
        torch.cuda.synchronize()
        max_d, exact = diff_stats(k, p)
        say(f"resample_fused_batched lanczos3 N={BATCH}: max {max_d} LSB, exact {exact:.7f}")
        check(max_d <= 1, f"resample_fused_batched: {max_d} LSB")
        for i, key in enumerate(("a", "b", "n1", "n2")):
            check(torch.equal(k[i], rc.resample_fused(on_dev[key], lz)), "batch != single frame")
        errs["resample_fused_batched"] = max_d
        prev = rc.resample_plain(on_dev["n2"], lz)
        for ts in ((0.5,), (1.0 / 3.0, 2.0 / 3.0)):
            for key in ("b", "n1"):
                k = rc.resample_fused_blend(on_dev[key], prev, lz, ts)
                p = rc.resample_blend_plain(on_dev[key], prev, lz, ts)
                own = rc.mix_plain(prev, k[0], ts)
                torch.cuda.synchronize()
                stats = [diff_stats(x, y) for x, y in zip(k, p)]
                say(f"resample_fused_blend ts={[round(t, 4) for t in ts]} [{key}]: "
                    + ", ".join(f"out{i} max {m} LSB exact {e:.7f}" for i, (m, e) in enumerate(stats)))
                check(all(m <= 1 for m, _ in stats), f"resample_fused_blend: {stats}")
                check(all(torch.equal(x, y) for x, y in zip(k[1:], own)),
                      "blend mids are not the exact round-mix of the kernel's own upscale")
                errs["resample_fused_blend"] = max(errs["resample_fused_blend"], *(m for m, _ in stats))

        # the soft warp, fed the same tiles as its plain version: the bench
        # pair with its own flow tiles, and a noise pair with random motion
        # kept off integers (a tile mean on an integer may floor either way)
        soft_cases = []
        for tile in SOFT_TILES:
            ty, tx = IN_H // tile[0], IN_W // tile[1]
            motion = rng.uniform(-20.0, 20.0, (ty, tx, 2)).astype(np.float32)
            motion = np.floor(motion) + 0.37
            soft_cases.append((tile, "bench", on_dev["a"], on_dev["b"],
                               interp.flow_tiles_fast(on_dev["a"], on_dev["b"], tile)))
            soft_cases.append((tile, "noise", on_dev["n1"], on_dev["n2"],
                               torch.from_numpy(motion).to(dev)))
        errs["soft_warp_blend"] = 0
        for tile, key, fa, fb, tiles in soft_cases:
            for k_soft in (interp.SOFT_WARP_K, interp.WARP_K):
                for t in (0.5, 1.0 / 3.0, 2.0 / 3.0):
                    kout = swc.soft_warp_blend(fa, fb, tiles, t, tile, interp.WARP_RANGE, k_soft)
                    pout = swc.soft_warp_plain(
                        fa, fb, swc.frame_inputs(tiles, t, k_soft, interp.WARP_RANGE), tile)
                    torch.cuda.synchronize()
                    max_d, exact = diff_stats(kout, pout)
                    say(f"soft_warp_blend tile={tile} [{key}] k={k_soft} t={t:.4f}: "
                        f"max {max_d} LSB, exact {exact:.7f}")
                    check(max_d <= 1, f"soft_warp_blend: {max_d} LSB")
                    errs["soft_warp_blend"] = max(errs["soft_warp_blend"], max_d)

    with Phase("4 main path"):
        t0 = time.perf_counter()
        wv = torch.from_numpy(ref.filter_weights(IN_H, OUT_H, "lanczos3")).cuda().double()
        wh = torch.from_numpy(ref.filter_weights(IN_W, OUT_W, "lanczos3")).cuda().double()
        g = {key: golden(torch, frames[key], wv, wh) for key in ("a", "b")}
        torch.cuda.synchronize()
        g = {key: v.cpu().numpy() for key, v in g.items()}
        say(f"float64 lanczos3 goldens of a and b on the card: {time.perf_counter() - t0:.2f} s")

        live_in = [np.roll(frames["a"], 16 * i, axis=1) for i in range(LIVE_FRAMES)]
        rc.reset_launches()
        up = PyWgpuUpscaler("ultra", "lanczos3")
        up.initialize(IN_W, IN_H, OUT_W, OUT_H)
        out_a = np.frombuffer(up.upscale(frames["a"].tobytes()), np.uint8).reshape(OUT_H, OUT_W, 4)
        outs_b = up.upscale_batch([frames[k].tobytes() for k in ("a", "b", "n1", "n2")])
        mid_bytes = WgpuFrameInterpolator().interpolate_py(
            frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H, time_t=0.5)
        step = resample.make_fused_blend(IN_H, IN_W, OUT_H, OUT_W, "lanczos3", 0.5)

        def make_fused_pipe():
            return LivePipeline(None, depth=2, fused_step_fn=step)

        pipe = make_fused_pipe()
        live_out = []
        for f in live_in:
            live_out += pipe.put(f)
        live_out += pipe.drain()
        torch.cuda.synchronize()
        counts = dict(rc.launches)
        say(f"launches on the main path: {json.dumps(counts)}")
        check(all(n > 0 for n in counts.values()), f"a kernel of the path never ran: {counts}")

        p_up = psnr(out_a, g["a"])
        say(f"upscale lanczos3 vs golden: {p_up:.2f} dB, max "
            f"{int(np.abs(out_a.astype(int) - g['a']).max())} LSB, exact "
            f"{float((out_a == g['a']).mean()):.7f}")
        check(p_up >= PSNR_GATE_DB, f"upscale {p_up:.2f} dB < {PSNR_GATE_DB}")
        check(len(outs_b) == BATCH and all(len(o) == OUT_W * OUT_H * 4 for o in outs_b),
              "upscale_batch byte lengths")
        check(outs_b[0] == out_a.tobytes(), "upscale_batch[0] != upscale(a)")
        p_b = psnr(np.frombuffer(outs_b[1], np.uint8).reshape(OUT_H, OUT_W, 4), g["b"])
        say(f"upscale_batch[1] (b) vs golden: {p_b:.2f} dB")
        check(p_b >= PSNR_GATE_DB, f"upscale_batch {p_b:.2f} dB < {PSNR_GATE_DB}")

        mid = np.frombuffer(mid_bytes, np.uint8).reshape(IN_H, IN_W, 4)
        want = interp.blend_only(torch.from_numpy(frames["a"]), torch.from_numpy(frames["b"]), 0.5)
        check(np.array_equal(mid, want.numpy()), "interpolate_py on the card != blend_only on the CPU")
        say("interpolate_py blend at 1080p: equal to blend_only on the CPU")

        check(len(live_out) == 2 * LIVE_FRAMES - 1, f"live frames: {len(live_out)}")
        check(all(o.shape == (OUT_H, OUT_W, 4) and o.dtype == np.uint8 for o in live_out),
              "live frame shape or type")
        for i in range(0, len(live_out) - 2, 2):  # every mid is the round-mix of its neighbours
            a_, b_ = live_out[i].astype(np.float32), live_out[i + 2].astype(np.float32)
            m_ = np.clip(np.round(a_ + (b_ - a_) * np.float32(0.5)), 0, 255).astype(np.uint8)
            check(np.array_equal(live_out[i + 1], m_), f"live mid {i + 1} != mix of its neighbours")
        gm = np.clip(np.round((g["a"].astype(np.float64) + g["b"].astype(np.float64)) * 0.5),
                     0, 255).astype(np.uint8)
        p_live0, p_mid = psnr(live_out[0], g["a"]), psnr(live_out[1], gm)
        say(f"live pipeline: {len(live_out)} frames; first vs golden {p_live0:.2f} dB; "
            f"mid vs round((golden_a + golden_b)/2) {p_mid:.2f} dB")
        check(p_live0 >= PSNR_GATE_DB and p_mid >= PSNR_GATE_DB, "live pipeline below the gate")

        # end to end on the host clock: one upscale(bytes) call, and the live
        # pipeline's output frames per second (host frames in, device frames out)
        lat = []
        for _ in range(6):
            t0 = time.perf_counter()
            up.upscale(frames["a"].tobytes())
            lat.append((time.perf_counter() - t0) * 1e3)
        say("e2e: " + json.dumps({
            "upscale_bytes_ms_median": float(np.median(lat[1:])),
            "live_fused_output_fps_device": live_fps(torch, make_fused_pipe, live_in, False),
            "live_fused_output_fps_host": live_fps(torch, make_fused_pipe, live_in, True),
        }))

    with Phase("4b flow_soft path"):
        # the counts are read for this path on its own
        up_fn = resample.make_resampler(IN_H, IN_W, OUT_H, OUT_W, "lanczos3")
        interp_fn = interp.make_interpolator(IN_H, IN_W, "flow_soft")
        fs = WgpuFrameInterpolator(mode="flow_soft")
        rc.reset_launches()
        swc.reset_launches()
        mid_fs = fs.interpolate_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H,
                                   time_t=0.5)
        mids_3x = fs.interpolate_multi_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H)
        fpipe = LivePipeline(up_fn, interp_fn, depth=2)
        flow_out = []
        per_step = []
        for f in live_in:
            before = (swc.launches["soft_warp_blend"], rc.launches["resample_fused"])
            flow_out += fpipe.put(f)
            per_step.append((swc.launches["soft_warp_blend"] - before[0],
                             rc.launches["resample_fused"] - before[1]))
        flow_out += fpipe.drain()
        torch.cuda.synchronize()
        flow_counts = {**rc.launches, **swc.launches}
        say(f"launches on the flow_soft path: {json.dumps(flow_counts)}; per live step "
            f"(soft_warp_blend, resample_fused): {per_step}")
        check(per_step[0] == (0, 1) and all(c == (1, 2) for c in per_step[1:]),
              f"flow_soft live step launches: {per_step}")
        check(flow_counts["soft_warp_blend"] == 1 + 2 + (LIVE_FRAMES - 1),
              f"soft_warp_blend launches: {flow_counts}")

        # the mids against the plain version's on the same tiles (the port's
        # psnr_flow_soft_db and psnr_soft3x_mids_db)
        tiles = interp.flow_tiles_fast(on_dev["a"], on_dev["b"])
        mid_fs, *mids_3x = (np.frombuffer(m, np.uint8).reshape(IN_H, IN_W, 4)
                            for m in (mid_fs, *mids_3x))
        gates = {}
        for name, got, t in (("psnr_flow_soft_db", mid_fs, 0.5),
                             ("psnr_soft3x_mid1_db", mids_3x[0], 1.0 / 3.0),
                             ("psnr_soft3x_mid2_db", mids_3x[1], 2.0 / 3.0)):
            plain = swc.soft_warp_plain(
                on_dev["a"], on_dev["b"],
                swc.frame_inputs(tiles, t, interp.SOFT_WARP_K, interp.WARP_RANGE),
                interp.WARP_TILE).cpu().numpy()
            gates[name] = psnr(got, plain)
        # value: on a smooth texture moved by 8 px the true mid is the texture
        # moved by 4 px; motion compensation must beat the cross-fade
        w0, w8, w4 = (wave_pattern(IN_W, IN_H, s_) for s_ in (0.0, 8.0, 4.0))
        wave_mid = np.frombuffer(fs.interpolate_py(w0.tobytes(), w8.tobytes(), IN_W, IN_H),
                                 np.uint8).reshape(IN_H, IN_W, 4)
        blend_mid = interp.blend_only(torch.from_numpy(w0), torch.from_numpy(w8), 0.5).numpy()
        gates["wave_mid_vs_truth_db"] = psnr(wave_mid, w4)
        gates["wave_blend_vs_truth_db"] = psnr(blend_mid, w4)
        # the flow stage on the card against the same functions on the CPU,
        # and with TF32 allowed (the flow stage uses no matmul or convolution)
        cpu_tiles = interp.flow_tiles_fast(torch.from_numpy(frames["a"]), torch.from_numpy(frames["b"]))
        gates["flow_tiles_card_vs_cpu_px"] = float((tiles.cpu() - cpu_tiles).abs().max())
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            tf32_tiles = interp.flow_tiles_fast(on_dev["a"], on_dev["b"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        gates["flow_tiles_tf32_equal"] = bool(torch.equal(tf32_tiles, tiles))
        gates["mean_tile_motion_px"] = [float(v) for v in tiles.mean(dim=(0, 1)).cpu()]
        say("flow_soft gates: " + json.dumps(gates))
        for name in ("psnr_flow_soft_db", "psnr_soft3x_mid1_db", "psnr_soft3x_mid2_db"):
            check(gates[name] >= PSNR_GATE_DB, f"{name} {gates[name]:.2f} dB < {PSNR_GATE_DB}")
        check(gates["wave_mid_vs_truth_db"] > gates["wave_blend_vs_truth_db"],
              "flow_soft does not beat the cross-fade on the moving texture")
        check(gates["flow_tiles_card_vs_cpu_px"] <= FLOW_TILE_GATE_PX, "flow tiles: card != CPU")
        check(gates["flow_tiles_tf32_equal"], "the flow stage changed with TF32 allowed")
        check(len(flow_out) == 2 * LIVE_FRAMES - 1, f"flow_soft live frames: {len(flow_out)}")
        check(all(o.shape == (OUT_H, OUT_W, 4) and o.dtype == np.uint8 for o in flow_out),
              "flow_soft live frame shape or type")
        up_mid = up_fn(torch.from_numpy(mid_fs.copy())).cpu().numpy()
        check(np.array_equal(flow_out[1], up_mid), "live flow_soft mid != upscale(interpolate_py)")

        # end to end: interpolate_py latency (host clock), live output fps
        # (outputs on the card), and the per-step split from CUDA events
        lat = []
        for _ in range(6):
            t0 = time.perf_counter()
            fs.interpolate_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H)
            lat.append((time.perf_counter() - t0) * 1e3)
        split = {"flow_ms": [], "warp_ms": [], "upscales_ms": [], "step_ms": []}
        prev_f, cur_f = on_dev["a"], on_dev["b"]
        for _ in range(SPLIT_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            tl = interp.flow_tiles_fast(prev_f, cur_f)
            ev[1].record()
            mid = swc.soft_warp_blend(prev_f, cur_f, tl, 0.5, interp.WARP_TILE, interp.WARP_RANGE,
                                      interp.SOFT_WARP_K)
            ev[2].record()
            up_fn(mid)
            up_fn(cur_f)
            ev[3].record()
            ev[3].synchronize()
            split["flow_ms"].append(ev[0].elapsed_time(ev[1]))
            split["warp_ms"].append(ev[1].elapsed_time(ev[2]))
            split["upscales_ms"].append(ev[2].elapsed_time(ev[3]))
            split["step_ms"].append(ev[0].elapsed_time(ev[3]))
        say("e2e flow_soft: " + json.dumps({
            "interpolate_py_flow_soft_ms_median": float(np.median(lat[1:])),
            "live_flow_soft_output_fps_device": live_fps(
                torch, lambda: LivePipeline(up_fn, interp_fn, depth=2), live_in, False),
            **{f"{k}_median": float(np.median(v)) for k, v in split.items()},
        }))

    with Phase("5 times"):
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        tables = 4 * (OUT_H * (1 + lz.kv) + OUT_W * (1 + lz.kh))
        frame_in, frame_out = IN_H * IN_W * 4, OUT_H * OUT_W * 4

        def bound(n: int, n_ts: int) -> tuple[float, str]:
            moved = n * frame_in + n * frame_out * (1 + n_ts) + (frame_out if n_ts else 0) + tables
            ops = 2 * n * 4 * (lz.nnz_v * IN_W + lz.nnz_h * OUT_H) + 3 * n_ts * frame_out
            t_bytes, t_ops = moved / mem_bw * 1e3, ops / f32_rate * 1e3
            say(f"  work: {moved} bytes, {ops} fp32 operations")
            return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

        single, prev = on_dev["a"], rc.resample_plain(on_dev["n2"], lz)
        cases = {
            "resample_fused": (
                lambda: rc.resample_fused(single, lz), lambda: rc.resample_plain(single, lz), 1, 0),
            "resample_fused_batched": (
                lambda: rc.resample_fused_batched(batch, lz), lambda: rc.resample_plain(batch, lz),
                BATCH, 0),
            "resample_fused_blend": (
                lambda: rc.resample_fused_blend(on_dev["b"], prev, lz, (0.5,)),
                lambda: rc.resample_blend_plain(on_dev["b"], prev, lz, (0.5,)), 1, 1),
            "resample_fused_blend ts=(1/3,2/3)": (
                lambda: rc.resample_fused_blend(on_dev["b"], prev, lz, (1 / 3, 2 / 3)),
                lambda: rc.resample_blend_plain(on_dev["b"], prev, lz, (1 / 3, 2 / 3)), 1, 2),
        }
        rows = []
        launched = {name: counts[name] + flow_counts.get(name, 0) for name in counts}
        for name, (kernel, plain, n, n_ts) in cases.items():
            b_ms, b_by = bound(n, n_ts)
            ms, plain_ms = time_ms(torch, kernel, flush), time_ms(torch, plain, flush)
            say(f"time {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
                f"{100 * b_ms / ms:.1f}% of bound)")
            if name in REPLACES:
                rows.append({
                    "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                    "launches": launched[name], "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    # no single PyTorch call computes a lanczos3 / filter-table resample
                    "library_ms": None,
                })

        # the soft warp at the main path's inputs (the bench pair's flow
        # tiles, K = 4, t = 0.5, tile (8, 128)), and at K = 8 and random motion
        soft_timed = {
            "main": (on_dev["a"], on_dev["b"], tiles, interp.SOFT_WARP_K),
            "k8": (on_dev["a"], on_dev["b"], tiles, interp.WARP_K),
            "noise": (on_dev["n1"], on_dev["n2"], soft_cases[1][4], interp.SOFT_WARP_K),
        }
        soft_ms = {}
        for name, (fa, fb, tl, k_soft) in soft_timed.items():
            # the kernel alone on its packed inputs; the wrapper's front end
            # (candidates: a scatter-add, a sort, an argmin) is timed apart
            fin = swc.frame_inputs(tl, 0.5, k_soft, interp.WARP_RANGE)
            packed = swc.pack_inputs(fin)
            moved, ops = soft_warp_work(torch, swc, fa, tl, 0.5, interp.WARP_TILE, k_soft,
                                        interp.WARP_RANGE)
            t_bytes, t_ops = moved / mem_bw * 1e3, ops / f32_rate * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ms = time_ms(torch, lambda: swc._launch(fa, fb, fin, packed, interp.WARP_TILE, k_soft),
                         flush)
            wrapper_ms = time_ms(torch, lambda: swc.soft_warp_blend(
                fa, fb, tl, 0.5, interp.WARP_TILE, interp.WARP_RANGE, k_soft), flush)
            plain_ms = time_ms(torch, lambda: swc.soft_warp_plain(fa, fb, fin, interp.WARP_TILE),
                               flush)
            say(f"time soft_warp_blend [{name}] k={k_soft}: {ms:.4f} ms (with its front end "
                f"{wrapper_ms:.4f} ms; plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}: "
                f"{moved} bytes, {ops} fp32 operations; {100 * b_ms / ms:.1f}% of bound)")
            soft_ms[name] = (ms, plain_ms, b_ms, b_by)
        (ms, plain_ms, b_ms, b_by), noise = soft_ms["main"], soft_ms["noise"]
        rows.append({
            "name": "soft_warp_blend", "route": "cuda", "source": SOFT_SOURCE,
            "replaces": REPLACES["soft_warp_blend"],
            "launches": flow_counts["soft_warp_blend"],
            "max_abs_err": errs["soft_warp_blend"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes the 4-corner candidate blend
            "library_ms": None,
            # the main path's pair has small, uniform motion (few candidates
            # per cell, the cheap case); the noise pair's random tile motion
            # is the costly one, timed on the same terms
            "inputs": "bench pair and its flow tiles, K=4, t=0.5, tile (8,128)",
            "ms_random_motion": noise[0], "plain_ms_random_motion": noise[1],
            "bound_ms_random_motion": noise[2], "bound_by_random_motion": noise[3],
        })

    with Phase("6 trace"):
        # profiler windows over 7 live steps each (host frames in, device
        # frames out): where a step's time goes, and the device's idle share
        from pathlib import Path

        busy = trace_steps(torch, make_fused_pipe(), live_in,
                           Path(_build.BUILD_DIR) / "live_trace.json")
        say("trace: " + json.dumps(busy))
        busy = trace_steps(torch, LivePipeline(up_fn, interp_fn, depth=2), live_in,
                           Path(_build.BUILD_DIR) / "flow_soft_trace.json")
        say("trace flow_soft: " + json.dumps(busy))

    say(f"total {time.perf_counter() - T_START:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
