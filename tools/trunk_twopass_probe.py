"""Split the fused trunk's and the two-call resample's time on an NVIDIA card.

Times `nu_scaler_tpu_torch/kernels/csrc/trunk_fused.cu` on the learned
path's inputs (the committed tpu4b2 / tpu4 weights on the s2d of the bench
frame, round_sum as served: ×2 1×270×480, ×4 1×135×240, ×2 N = 4), as
chip_smoke.py phase 5 times it, and `csrc/resample_twopass.cu` at 1080p→4K
lanczos3 on the bench frame (both launches, and each alone). For the trunk
it also times parts of the work on their own:

* a trunk of 0 residual blocks (3 layers: head, trunk conv, tail) against
  the served 2 blocks (7 layers) at ×2: their difference over 4 is the cost
  of one 128 → 128 layer with its waits on the layer before;
* "synchronisation only": a source variant whose work items skip the conv
  and the stores, so the launch is the items' waits on ready flags, their
  signals and the block's barriers and nothing else (its bytes are wrong;
  only its time means anything);
* the weights' repack alone (`trunk_cuda.pack_params`), which the wrapper
  makes per call.

It also times `csrc/conv3x3.cu`, whose main loop the trunk shares
(`csrc/conv3x3_core.cuh`), at chip_smoke.py's five conv shapes (the
committed block and tail weights on the same inputs).

With `--baseline` it also builds the three sources of another commit and
times them as built in turns with the checkout's (baseline, checkout,
checkout, baseline), so both stand on one card in one run. The card's
machine holds no git history, so fetch them first, in a checkout:

    python3 tools/trunk_twopass_probe.py --fetch-baseline HEAD~1

which writes the commit's `trunk_fused.cu`, `resample_twopass.cu` and
`conv3x3.cu` (by
`git show <commit>:<path>`) under `build/trunk_twopass_baseline/`
(gitignored) and exits; then, on a machine with a card and `nvcc`:

    python3 tools/trunk_twopass_probe.py [--baseline]

The baseline is launched through its own C interfaces, those of the sources
before the layer-synchronous trunk (`nu_trunk_fused` with per-block window
scratch and a tile plan, as that commit's `trunk_cuda._launch` called it)
and before the banded two-call resample (`nu_resample_vert` and
`nu_resample_horiz` on the compact tap tables); `conv3x3.cu`'s interface
is the checkout's.

Each source is built like the package's library (`kernels/_build.py`, one
`nvcc`) from a copy under `build/nu_scaler_tpu_torch/probe/`, with the
headers it includes. Prints one line per source, variant and input (median
of 20 CUDA-event timings, the L2 cache flushed before each, as
chip_smoke.py times), with ptxas' registers and spill stores, then the
card's name and power limit. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BASELINE_DIR = ROOT / "build" / "trunk_twopass_baseline"
SOURCES = ("trunk_fused", "resample_twopass", "conv3x3")
CSRC_REL = "nu_scaler_tpu_torch/kernels/csrc"

# the layer-by-layer trunk with its items' conv and stores skipped: the
# synchronisation only
_TRUNK_SYNC_ONLY = [("      conv_tile<TH, TW, NS>(halo, role.src", "      if (g.n < 0) conv_tile<TH, TW, NS>(halo, role.src"),
                    ("    for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {",
                     "    for (int i = tid; i < 0; i += kThreads) {")]

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# the C interfaces of the sources before this design (see the docstring)
_BASE_TRUNK_ARGS = [_INT, _VP, _VP, _VP, _INT, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                    _INT, _INT, _INT, _INT, _VP]
_BASE_VERT_ARGS = [_INT, _VP, _INT, _INT, _INT, _VP, _VP, _INT, _INT, _VP, _VP]


def fetch_baseline(rev: str) -> int:
    """Write `rev`'s two sources under BASELINE_DIR (needs the git history)."""
    BASELINE_DIR.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        text = subprocess.run(["git", "show", f"{rev}:{CSRC_REL}/{name}.cu"], cwd=ROOT,
                              capture_output=True, text=True, check=True).stdout
        (BASELINE_DIR / f"{name}.cu").write_text(text)
    commit = subprocess.run(["git", "rev-parse", rev], cwd=ROOT, capture_output=True, text=True,
                            check=True).stdout.strip()
    (BASELINE_DIR / "COMMIT").write_text(f"{rev} {commit}\n")
    print(f"baseline {rev} ({commit}) written to {BASELINE_DIR}")
    return 0


def base_trunk_plan(n, h, w, blocks, cin, cmid, cout, slots):
    """The window-scratch trunk's (tile_h, tile_w, grid): the tile among its
    candidates that minimised the sub-tiles one block computes, halo
    included (that commit's `trunk_cuda.tile_plan`)."""
    d = 3 + 2 * blocks
    best = None
    for th in (8, 16, 24, 32):
        for tw in (16, 32, 48, 64):
            per_tile = 0
            for layer in range(d):
                grow = 2 * (d - 1 - layer)
                c_in = cin if layer == 0 else cmid
                c_out = cout if layer == d - 1 else cmid
                per_tile += (math.ceil((th + grow) / 8) * math.ceil((tw + grow) / 16)
                             * (c_in // 128) * (c_out // 128))
            tiles = n * math.ceil(h / th) * math.ceil(w / tw)
            key = (math.ceil(tiles / slots) * per_tile, th * tw)
            if best is None or key < best[0]:
                best = (key, th, tw, min(tiles, slots))
    return best[1:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="store_true",
                    help=f"also time the sources fetched into {BASELINE_DIR}")
    ap.add_argument("--fetch-baseline", metavar="REV", default=None,
                    help="write REV's two sources for --baseline (by git show) and exit")
    args = ap.parse_args()
    if args.fetch_baseline is not None:
        return fetch_baseline(args.fetch_baseline)
    import torch

    if not torch.cuda.is_available():
        print("trunk_twopass_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.kernels import conv_cuda as cc
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc
    from nu_scaler_tpu_torch.kernels import trunk_cuda as tc
    from nu_scaler_tpu_torch.models import esrgan_lite as pel
    from nu_scaler_tpu_torch.ops import resample

    chip_smoke.set_tf32(torch, False)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bench = chip_smoke.bench_frame(1080, 1920)
    frames = [bench, np.roll(bench, 16, axis=1)]
    rng = np.random.default_rng(0)
    frames += [rng.integers(0, 256, (1080, 1920, 4), np.uint8) for _ in range(2)]
    s2 = pel.make_pretrained_upscaler(1080, 1920, 2160, 3840, "ultra", dev).serving
    s4 = pel.make_pretrained_upscaler(540, 960, 2160, 3840, "ultra", dev).serving
    x2 = s2.trunk_input(torch.from_numpy(frames[0][None]).to(dev))[1]
    x2n = s2.trunk_input(torch.from_numpy(np.stack(frames)).to(dev))[1]
    x4 = s4.trunk_input(torch.from_numpy(chip_smoke.bench_frame(540, 960)[None]).to(dev))[1]
    p2, p4 = s2.trunk_params, s4.trunk_params
    p2_0 = tuple(p2[:2]) + tuple(p2[-4:])  # head, trunk conv, tail: 0 blocks
    trunk_in = {"x2": (x2, p2, 2), "x4": (x4, p4, 3), "x2 N=4": (x2n, p2, 2),
                "x2 0 blocks (3 layers)": (x2, p2_0, 0)}
    conv_in = {"x2 block": (x2, *s2.blocks[0][1]), "x2 tail": (x2, *s2.tail),
               "x2 block N=4": (x2n, *s2.blocks[0][1]), "x4 block": (x4, *s4.blocks[0][1]),
               "x4 tail": (x4, *s4.tail)}
    lz = resample.make_resampler(1080, 1920, 2160, 3840, "lanczos3", dev).plan
    src = torch.from_numpy(bench).to(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    csrc = _build.CSRC

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    def use(library: str, tag: str, text: str):
        """Build `text` as `library` (with the checkout's headers beside it),
        load it in the wrappers' place; (the library, ptxas' registers and
        spill stores per kernel)."""
        d = _build.BUILD_DIR / "probe" / re.sub(r"\W+", "_", tag)
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / f"{library}.cu").write_text(text)
        _build.CSRC = d
        _build.load_library.cache_clear()
        _build.BUILD_LOGS.pop(library, None)
        lib = _build.load_library(library)
        log = _build.BUILD_LOGS.get(library, "")
        if not log:
            return lib, "built before this run"
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        return lib, f"registers {regs}, spill stores {spills} bytes"

    def base_trunk(lib, x, params, blocks):
        lib.nu_trunk_fused.argtypes = _BASE_TRUNK_ARGS
        n, h, w, cin = x.shape
        cmid, cout = params[0].shape[-1], params[-1].shape[0]
        th, tw, grid = base_trunk_plan(n, h, w, blocks, cin, cmid, cout, 2 * sms)
        d = 3 + 2 * blocks
        grow = 2 * (d - 1)
        scratch = torch.empty(grid * 3 * (th + grow) * (tw + grow) * cmid, dtype=torch.bfloat16, device=dev)
        out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=dev)
        ks = (ctypes.c_void_p * d)(*(params[2 * i].data_ptr() for i in range(d)))
        bs = (ctypes.c_void_p * d)(*(params[2 * i + 1].data_ptr() for i in range(d)))
        err = lib.nu_trunk_fused(0, x.data_ptr(), ks, bs, d, scratch.data_ptr(), out.data_ptr(), n, h, w,
                                 cin, cmid, cout, blocks, th, tw, grid, 1,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline trunk launch failed ({err})")
        return out

    def base_twopass(lib, part: str):
        lib.nu_resample_vert.argtypes = _BASE_VERT_ARGS
        lib.nu_resample_horiz.argtypes = _BASE_VERT_ARGS
        stream = torch.cuda.current_stream().cuda_stream
        mid = torch.empty((1, lz.out_h, lz.in_w, 4), dtype=torch.float32, device=dev)
        dst = torch.empty((1, lz.out_h, lz.out_w, 4), dtype=torch.uint8, device=dev)
        if part in ("both", "vertical"):
            lib.nu_resample_vert(0, src.data_ptr(), 1, lz.in_h, lz.in_w, lz.first_v.data_ptr(),
                                 taps_v.data_ptr(), lz.kv, lz.out_h, mid.data_ptr(), stream)
        if part in ("both", "horizontal"):
            lib.nu_resample_horiz(0, mid.data_ptr(), 1, lz.out_h, lz.in_w, lz.first_h.data_ptr(),
                                  taps_h.data_ptr(), lz.kh, lz.out_w, dst.data_ptr(), stream)
        return dst

    mid = rc._launch_vert(src[None], 1, lz)
    taps_v, taps_h = (torch.from_numpy(lz._np[i]).to(dev) for i in (1, 3))  # the compact tap tables
    checkout_calls = {
        "trunk_fused": {name: (lambda a=a: tc.trunk_fused(*a, True)) for name, a in trunk_in.items()},
        "resample_twopass": {
            "both": lambda: rc.resample_twopass(src, lz),
            "vertical": lambda: rc._launch_vert(src[None], 1, lz),
            "horizontal": lambda: rc._launch_horiz(mid, 1, lz),
        },
        "conv3x3": {name: (lambda a=a: cc.conv3x3(*a, False, True)) for name, a in conv_in.items()},
    }

    def baseline_calls(library, lib):
        if library == "conv3x3":  # the same C interface
            return checkout_calls[library]
        if library == "trunk_fused":
            return {name: (lambda a=a: base_trunk(lib, *a)) for name, a in trunk_in.items()}
        return {part: (lambda part=part: base_twopass(lib, part)) for part in ("both", "vertical", "horizontal")}

    texts = {"checkout": {name: (csrc / f"{name}.cu").read_text() for name in SOURCES}}
    if args.baseline:
        if not all((BASELINE_DIR / f"{name}.cu").is_file() for name in SOURCES):
            print(f"trunk_twopass_probe: no baseline under {BASELINE_DIR}; run --fetch-baseline first",
                  file=sys.stderr)
            return 2
        texts["baseline"] = {name: (BASELINE_DIR / f"{name}.cu").read_text() for name in SOURCES}
        print(f"baseline: {(BASELINE_DIR / 'COMMIT').read_text().strip()}", flush=True)
    try:
        for library in SOURCES:
            if "baseline" in texts:
                got = {"baseline": {}, "checkout": {}}
                for who in ("baseline", "checkout", "checkout", "baseline"):
                    lib, regs = use(library, f"{library} {who} as built", texts[who][library])
                    calls = checkout_calls[library] if who == "checkout" else baseline_calls(library, lib)
                    for name, fn in calls.items():
                        got[who].setdefault(name, []).append(time_ms(fn))
                    print(f"{library} {who} as built: {regs}", flush=True)
                for name in got["checkout"]:
                    print(f"{library} [{name}] in turns (baseline, checkout, checkout, baseline): "
                          + ", ".join(f"{who} {np.mean(t[name]):.4f} ms "
                                      f"({', '.join(f'{v:.4f}' for v in t[name])})"
                                      for who, t in got.items()), flush=True)
            _, regs = use(library, f"{library} checkout as built", texts["checkout"][library])
            times = {name: round(time_ms(fn), 4) for name, fn in checkout_calls[library].items()}
            print(f"{library} checkout, as built: ms {times} ({regs})", flush=True)
            if library == "trunk_fused":
                seven, three = times["x2"], times["x2 0 blocks (3 layers)"]
                print(f"trunk_fused checkout: one 128 -> 128 layer with its waits at x2 "
                      f"{(seven - three) / 4:.4f} ms ((7 layers - 3 layers) / 4)", flush=True)
                pack = {name: round(time_ms(lambda a=a: tc.pack_params(a[1])), 4)
                        for name, a in trunk_in.items() if name in ("x2", "x4")}
                print(f"trunk_fused checkout, the weights' repack alone: ms {pack}", flush=True)
                text = texts["checkout"][library]
                if all(old in text for old, _ in _TRUNK_SYNC_ONLY):
                    for old, new in _TRUNK_SYNC_ONLY:
                        text = text.replace(old, new)
                    _, regs = use(library, f"{library} checkout synchronisation only", text)
                    times = {name: round(time_ms(fn), 4) for name, fn in checkout_calls[library].items()}
                    print(f"trunk_fused checkout, synchronisation only (no conv, no stores; the repack "
                          f"included): ms {times} ({regs})", flush=True)
                else:
                    print("trunk_fused checkout: the source holds no item to empty", flush=True)
    finally:
        _build.CSRC = csrc
        _build.load_library.cache_clear()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=15)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
