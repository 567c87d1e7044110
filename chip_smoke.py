#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (nu_scaler_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printed on its own line with its seconds:

1. the card: its name, and its power limit as nvidia-smi reports it;
2. the build: one nvcc call per source under nu_scaler_tpu_torch/kernels/csrc/
   (resample_fused.cu, soft_warp.cu, fsr.cu), all started together, into
   build/nu_scaler_tpu_torch/;
3. each kernel wrapper against its plain PyTorch version on the card, at
   1080p→4K: lanczos3, bilinear and nearest single frames (nearest bit-exact,
   the others ≤1 LSB), a batch of 4, and the blend epilogue with t = 0.5 and
   t = (1/3, 2/3); the soft warp at 1080p (≤1 LSB) with K = 4 and 8,
   t = 0.5 and (1/3, 2/3), tiles (8, 128) and (8, 32), on the bench pair
   (its flow tiles) and on a noise pair with random tile motion; the fused
   FSR kernel (≤1 LSB, bit-exact the target) at s = 2 (1080p, all four
   sharpness tiers and 0.0), 3 (720p), 4 (540p) and 1, batches of 4 at s = 2
   and 3, and an odd 37×53 frame, on the bench frame and seeded noise, with
   the count of differing bytes;
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
4c. the FSR path, its launch counts read on their own: create_fsr_upscaler
   ("quality") upscale at 1080p→4K against the easu_ref → rcas_ref golden
   (≥40 dB and ≤12 LSB), upscale_batch of 4 equal to 4 upscale calls, 720p→4K
   (s = 3) against its plain version, 1366×768→1080p through the general
   path (plain PyTorch on the card) against the CPU (≤1 LSB), and a
   LivePipeline with the FSR upscaler and a flow_soft interpolator (the
   app's live FSR configuration). Then flow_soft on frames its warp tile
   does not divide (the ragged branch): 1366×768 and 1600×900 under the
   default preset and 1080p under "tall8x32", on the card against the CPU
   (≥50 dB RGB). On the host clock and CUDA events: the FSR upscale latency
   and frames per second, and the live FSR output fps;
5. times: per kernel the median of 20 CUDA-event timings after 3 warm-ups,
   the plain version's time, and the bound (the larger of bytes moved over
   the memory rate and fp32 operations over the fp32 rate);
6. torch.profiler traces of 7 fused live steps, of 7 flow_soft live steps
   and of 7 FSR + flow_soft live steps: the device's busy share, kernel
   launches per step and device time by kernel and copy.

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
FSR_SOURCE = "nu_scaler_tpu_torch/kernels/csrc/fsr.cu"
REPLACES = {
    "resample_fused": "nu_scaler_tpu/kernels/resample_pallas.py:268",
    "resample_fused_batched": "nu_scaler_tpu/kernels/resample_pallas.py:139",
    "resample_fused_blend": "nu_scaler_tpu/kernels/resample_pallas.py:371",
    "soft_warp_blend": "nu_scaler_tpu/kernels/soft_warp_pallas.py:984",
    "fsr": "nu_scaler_tpu/kernels/fsr_pallas.py:207",
    "fsr_batched": "nu_scaler_tpu/kernels/fsr_pallas.py:246",
}
FSR_GATE_DB, FSR_GATE_LSB = 40.0, 12  # the JAX side's psnr_fsr_db contract
# the FSR path's other sizes: 720p→4K (s = 3) and 540p (s = 4 in phase 3)
SIZES = {"720p": (720, 1280), "540p": (540, 960)}
GENERAL = ((768, 1366), (1080, 1920))  # a non-integer scale: the general path
# flow_soft frames that the warp tile does not divide: (h, w, preset)
RAGGED = ((768, 1366, None), (900, 1600, None), (1080, 1920, "tall8x32"))
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


def bench_frame(h: int, w: int) -> np.ndarray:
    """The bench input at h×w: the gradient pattern with a white box (at
    1080p rows 480:600, columns 640:760)."""
    a = gradient_pattern(w, h)
    a[h * 4 // 9: h * 5 // 9, w // 3: w * 19 // 48, :3] = 255
    return a


def make_frames(rng) -> dict:
    """Frame a is the bench input (gradient + white box); b is a rolled by 16
    columns; n1, n2 are seeded noise, the hardest case for 1-LSB parity."""
    a = bench_frame(IN_H, IN_W)
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


def fsr_work(torch, fc, src, s: int, sharp: float) -> tuple[int, int]:
    """(bytes, fp32 operations) of the fused FSR kernel on `src` u8
    [N, H, W, 4]: the input read once and the output written once; per input
    pixel 3 to load, 31 for the direction, 3 per phase (offs), 3 per tap
    (base), per tap and phase 2 (distance) + 2 (d², d³) + 1 (compare) + 7
    (accumulate) + 5 for the cubic where d ≤ 2 or 1 further compare where not,
    and per phase 9 to normalise and take luma (+9 with the sharpness mix);
    51 per output pixel for RCAS; as csrc/fsr.cu issues them, without its
    ring's recomputation. The cubic's share is counted on this input."""
    n, h, w = src.shape[0], src.shape[1], src.shape[2]
    rgb = src[..., :3].permute(0, 3, 1, 2).to(torch.float32) * fc.INV_255
    wx, wy = fc._direction(rgb)
    near = 0
    for py in range(s):
        for px in range(s):
            offs = float(np.float32((px + 0.5) / s)) * wx + float(np.float32((py + 0.5) / s)) * wy
            for ty in range(4):
                for tx in range(4):
                    near += int(((float(tx) * wx + float(ty) * wy - offs).abs() <= 2.0).sum().item())
    px_in = n * h * w
    mix = 9 if sharp > fc.SHARP_MIX_MIN else 0
    ops = px_in * (3 + 31 + 3 * s * s + 16 * 3 + 16 * s * s * 13 + s * s * (9 + mix))
    ops += 4 * near + 51 * px_in * s * s
    return px_in * 4 * (1 + s * s), ops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    from nu_scaler_tpu_torch.core import (
        PyFsrUpscaler,
        PyWgpuUpscaler,
        WgpuFrameInterpolator,
        create_fsr_upscaler,
    )
    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.kernels import fsr_cuda as fc
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

        # the fused FSR kernel, single frames and batches, at the main path's
        # sizes (s = 2 from 1080p, s = 3 from 720p), s = 4 from 540p, s = 1,
        # and an odd size
        sized = {key: bench_frame(h, w) for key, (h, w) in SIZES.items()}
        sized.update({f"{key}-noise": rng.integers(0, 256, (h, w, 4), np.uint8)
                      for key, (h, w) in SIZES.items()})
        sized["odd-noise"] = rng.integers(0, 256, (37, 53, 4), np.uint8)
        on_dev.update({k: torch.from_numpy(v).to(dev) for k, v in sized.items()})
        tiers = dict(ref.FSR_SHARPNESS, zero=0.0)
        fsr_cases = [(key, 2, name) for key in ("a", "n1") for name in tiers]
        fsr_cases += [(key, 3, name) for key in ("720p", "720p-noise") for name in ("quality", "zero")]
        fsr_cases += [(key, 4, name) for key in ("540p", "540p-noise") for name in ("quality", "performance")]
        fsr_cases += [("n1", 1, "quality")]
        fsr_cases += [("odd-noise", s_, "ultra") for s_ in (2, 3, 4)]
        fsr_cases += [(("a", "b", "n1", "n2"), 2, "quality"), (("720p", "720p-noise") * 2, 3, "ultra")]
        errs["fsr"] = errs["fsr_batched"] = 0
        for key, s_, name in fsr_cases:
            batched = isinstance(key, tuple)
            src = torch.stack([on_dev[k] for k in key]) if batched else on_dev[key]
            kout = (fc.fsr_batched if batched else fc.fsr)(src, s_, tiers[name])
            pout = fc.fsr_plain(src, s_, tiers[name])
            torch.cuda.synchronize()
            check(kout.shape == pout.shape, f"fsr shape {tuple(kout.shape)} != {tuple(pout.shape)}")
            d = (kout.to(torch.int16) - pout.to(torch.int16)).abs()
            n_diff, max_d = int((d > 0).sum().item()), int(d.max().item())
            say(f"fsr{'_batched' if batched else ''} s={s_} {name} "
                f"[{'+'.join(key) if batched else key}] {tuple(src.shape)}: "
                f"{n_diff} of {d.numel()} bytes differ, max {max_d} LSB")
            check(max_d <= 1, f"fsr: {max_d} LSB")
            row = "fsr_batched" if batched else "fsr"
            errs[row] = max(errs[row], max_d)

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

    with Phase("4c fsr path"):
        # the app's fsr tier at 1080p→4K; the counts are read for this path
        t0 = time.perf_counter()
        sharp = ref.FSR_SHARPNESS["quality"]
        fsr_golden = ref.rcas_ref(ref.easu_ref(frames["a"], OUT_H, OUT_W, sharp), sharp)
        say(f"easu_ref → rcas_ref golden of a at 1080p→4K on the host: "
            f"{time.perf_counter() - t0:.2f} s")
        fsr_up = create_fsr_upscaler("quality")
        fsr_up.initialize(IN_W, IN_H, OUT_W, OUT_H)
        up720 = create_fsr_upscaler("quality")
        up720.initialize(SIZES["720p"][1], SIZES["720p"][0], OUT_W, OUT_H)
        fsr_interp = interp.make_interpolator(IN_H, IN_W, "flow_soft")

        def make_fsr_pipe():
            return LivePipeline(fsr_up.upscale_arr, fsr_interp, depth=2)

        rc.reset_launches()
        swc.reset_launches()
        fc.reset_launches()
        fsr_a = np.frombuffer(fsr_up.upscale(frames["a"].tobytes()), np.uint8).reshape(OUT_H, OUT_W, 4)
        batch_keys = ("a", "b", "n1", "n2")
        fsr_batch = fsr_up.upscale_batch([frames[k].tobytes() for k in batch_keys])
        fsr_720 = up720.upscale(sized["720p"].tobytes())
        fpipe = make_fsr_pipe()
        fsr_live = []
        for f in live_in:
            fsr_live += fpipe.put(f)
        fsr_live += fpipe.drain()
        torch.cuda.synchronize()
        fsr_counts = {**fc.launches, **swc.launches}
        say(f"launches on the FSR path: {json.dumps(fsr_counts)} (resample: {json.dumps(rc.launches)})")
        check(all(n > 0 for n in fsr_counts.values()), f"a kernel of the FSR path never ran: {fsr_counts}")

        gates = {"psnr_fsr_db": psnr(fsr_a, fsr_golden),
                 "fsr_max_lsb": int(np.abs(fsr_a.astype(int) - fsr_golden).max()),
                 "fsr_exact": float((fsr_a == fsr_golden).mean())}
        singles = [fsr_up.upscale(frames[k].tobytes()) for k in batch_keys]
        gates["batch_equals_singles"] = fsr_batch == singles
        plain720 = fc.fsr_plain(on_dev["720p"], 3, sharp).cpu().numpy()
        gates["fsr_720p_vs_plain_max_lsb"] = int(np.abs(
            np.frombuffer(fsr_720, np.uint8).reshape(OUT_H, OUT_W, 4).astype(int) - plain720).max())
        (gh, gw), (goh, gow) = GENERAL
        g_in = bench_frame(gh, gw).tobytes()
        g_card = create_fsr_upscaler("quality")
        g_cpu = PyFsrUpscaler("quality", device="cpu")
        for u in (g_card, g_cpu):
            u.initialize(gw, gh, gow, goh)
        g_out = [np.frombuffer(u.upscale(g_in), np.uint8).astype(int) for u in (g_card, g_cpu)]
        gates["general_card_vs_cpu_max_lsb"] = int(np.abs(g_out[0] - g_out[1]).max())
        # the live FSR step: every mid is the FSR upscale of the flow_soft mid
        mid0 = fsr_interp(on_dev["a"], torch.from_numpy(live_in[1]).to(dev), 0.5)
        gates["live_frames"] = len(fsr_live)
        gates["live_mid_is_upscaled_mid"] = bool(np.array_equal(
            fsr_live[1], fsr_up.upscale_arr(mid0).cpu().numpy()))
        say("fsr gates: " + json.dumps(gates))
        check(gates["psnr_fsr_db"] >= FSR_GATE_DB and gates["fsr_max_lsb"] <= FSR_GATE_LSB,
              f"FSR vs golden: {gates['psnr_fsr_db']:.2f} dB, {gates['fsr_max_lsb']} LSB")
        check(gates["batch_equals_singles"], "FSR upscale_batch != upscale of each frame")
        check(gates["fsr_720p_vs_plain_max_lsb"] <= 1, "FSR 720p→4K != its plain version")
        check(gates["general_card_vs_cpu_max_lsb"] <= 1, "FSR general path: card != CPU")
        check(gates["live_frames"] == 2 * LIVE_FRAMES - 1, f"FSR live frames: {len(fsr_live)}")
        check(all(o.shape == (OUT_H, OUT_W, 4) and o.dtype == np.uint8 for o in fsr_live),
              "FSR live frame shape or type")
        check(gates["live_mid_is_upscaled_mid"], "FSR live mid != upscale(flow_soft mid)")

        # flow_soft on frames the warp tile does not divide: the card against
        # the CPU, on a texture moved 8 px
        ragged = {}
        for h_, w_, preset in RAGGED:
            w0, w8 = (wave_pattern(w_, h_, s_).tobytes() for s_ in (0.0, 8.0))
            card_i = WgpuFrameInterpolator(preset, mode="flow_soft")
            cpu_i = WgpuFrameInterpolator(preset, mode="flow_soft", device="cpu")
            check(not interp.soft_tiles_fit(h_, w_, card_i.warp_tile), "not a ragged case")
            outs = [np.frombuffer(i_.interpolate_py(w0, w8, w_, h_), np.uint8).reshape(h_, w_, 4)
                    for i_ in (card_i, cpu_i)]
            key = f"{w_}x{h_} tile {card_i.warp_tile}"
            ragged[key] = {"psnr_rgb_db": psnr(outs[0], outs[1]),
                           "max_lsb": int(np.abs(outs[0].astype(int) - outs[1]).max())}
            if preset is None and h_ == RAGGED[0][0]:
                multi = [[np.frombuffer(m, np.uint8).reshape(h_, w_, 4)
                          for m in i_.interpolate_multi_py(w0, w8, w_, h_)] for i_ in (card_i, cpu_i)]
                ragged[key]["multi_psnr_rgb_db"] = min(psnr(x, y) for x, y in zip(*multi))
        say("flow_soft ragged, card vs CPU: " + json.dumps(ragged))
        for key, r_ in ragged.items():
            check(min(v for k, v in r_.items() if "psnr" in k) >= PSNR_GATE_DB,
                  f"flow_soft ragged {key}: {r_}")

        # end to end: upscale(bytes) latency, device frames per second of
        # upscale_arr, and the live FSR + flow_soft output fps
        lat = []
        for _ in range(6):
            t0 = time.perf_counter()
            fsr_up.upscale(frames["a"].tobytes())
            lat.append((time.perf_counter() - t0) * 1e3)
        fsr_up.upscale_arr(on_dev["a"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fsr_up.upscale_arr(on_dev["a"])
        torch.cuda.synchronize()
        say("e2e fsr: " + json.dumps({
            "fsr_upscale_bytes_ms_median": float(np.median(lat[1:])),
            "fsr_upscale_arr_fps_device": 20 / (time.perf_counter() - t0),
            "live_fsr_flow_soft_output_fps_device": live_fps(torch, make_fsr_pipe, live_in, False),
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

        # the FSR kernel at the main path's inputs: the bench frame, quality
        # tier, 1080p→4K, 720p→4K, and a batch of 4 at 1080p→4K
        sharp = ref.FSR_SHARPNESS["quality"]
        fsr_batch_in = torch.stack([on_dev[k] for k in ("a", "b", "n1", "n2")])
        fsr_timed = {
            "1080p": (fc.fsr, on_dev["a"], 2),
            "720p": (fc.fsr, on_dev["720p"], 3),
            "batch4": (fc.fsr_batched, fsr_batch_in, 2),
        }
        fsr_ms = {}
        for name, (fn, src, s_) in fsr_timed.items():
            moved, ops = fsr_work(torch, fc, src if src.dim() == 4 else src[None], s_, sharp)
            t_bytes, t_ops = moved / mem_bw * 1e3, ops / f32_rate * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ms = time_ms(torch, lambda: fn(src, s_, sharp), flush)
            plain_ms = time_ms(torch, lambda: fc.fsr_plain(src, s_, sharp), flush)
            say(f"time fsr [{name}] s={s_} {tuple(src.shape)}: {ms:.4f} ms (plain {plain_ms:.4f} ms; "
                f"bound {b_ms:.4f} ms by {b_by}: {moved} bytes, {ops} fp32 operations; "
                f"{100 * b_ms / ms:.1f}% of bound)")
            fsr_ms[name] = (ms, plain_ms, b_ms, b_by)
        for row, key, inputs in (("fsr", "1080p", "bench frame 1080p→4K, quality"),
                                 ("fsr_batched", "batch4", "a, b, n1, n2 at 1080p→4K, quality")):
            ms, plain_ms, b_ms, b_by = fsr_ms[key]
            rows.append({
                "name": row, "route": "cuda", "source": FSR_SOURCE, "replaces": REPLACES[row],
                "launches": fsr_counts[row], "max_abs_err": errs[row], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                # no single PyTorch call computes EASU + RCAS
                "library_ms": None, "inputs": inputs,
            })
        ms, plain_ms, b_ms, b_by = fsr_ms["720p"]
        rows[-2].update({"ms_720p": ms, "plain_ms_720p": plain_ms, "bound_ms_720p": b_ms,
                         "bound_by_720p": b_by})

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
        busy = trace_steps(torch, make_fsr_pipe(), live_in,
                           Path(_build.BUILD_DIR) / "fsr_flow_soft_trace.json")
        say("trace fsr + flow_soft: " + json.dumps(busy))

    say(f"total {time.perf_counter() - T_START:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
