"""Split the FSR and soft-warp kernels' time on an NVIDIA card.

Times `nu_scaler_tpu_torch/kernels/csrc/fsr.cu` (1080p→4K at s = 2, 720p→4K
at s = 3, a batch of 4 at s = 2; the quality tier on the bench frame, as
chip_smoke.py phase 5 times it) and `csrc/soft_warp.cu` (1080p, K = 4,
t = 0.5, tile (8, 128): the bench pair with its flow tiles, and a noise pair
with random tile motion) as they are, then source variants with one part of
the work switched off:

* FSR: "EASU only" (no RCAS), "RCAS only" (no EASU: RCAS reads whatever
  shared memory holds), "loads only" (neither), "no stores" (the output is
  stored only where it equals one improbable pixel, so nothing is dropped
  as dead code);
* soft warp: "loads and conversions only" (each bilinear lerp becomes one
  add of its two ends, so the taps are still loaded and converted, and the
  fractions and the smoothed motion drop out), "no stores".

With `--baseline DIR` it does the same for the sources in DIR (the two files
of another commit, for example its parent's, unpacked with `git show
<commit>:nu_scaler_tpu_torch/kernels/csrc/fsr.cu > DIR/fsr.cu`) and times the
two as built in turns (baseline, checkout, checkout, baseline), so both
stand on one card in one run. The C interfaces must be the same.

Each variant is built like the package's library (`kernels/_build.py`, one
`nvcc`) from a copy of the source under `build/nu_scaler_tpu_torch/probe/`.
A variant that skips a part gives wrong bytes; only the timings mean
anything. A variant names the text it replaces in each design of the
source it knows, and the script stops if a source holds none of them.

Run from the root of a checkout, on a machine with a card and `nvcc`:

    python3 tools/fsr_soft_warp_probe.py [--baseline DIR]

Prints one line per source, variant and input (median of 20 CUDA-event
timings, the L2 cache flushed before each, as chip_smoke.py times), with
ptxas' registers and spill stores, then the card's name and power limit.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the stores kept behind a test that the data almost never passes
_RARE = "0xff030201u"

# fsr.cu as redesigned: RCAS skipped (h >= 1 always), or each EASU call
# replaced by a copy of the centre pixel into every phase
_FSR_NO_RCAS = [("    if (y >= h || x >= w) continue;", "    if (y >= h || x >= w || h > 0) continue;")]
_FSR_NO_EASU = [
    ("    easu<T, S, true>(s_in, (ry + 1) * T::kInW + rx + 1, fx, fy, sharp, mix, e);",
     "    { const int c_ = (ry + 1) * T::kInW + rx + 1;\n"
     "      for (int p = 0; p < kPh; ++p) e[p] = make_float4(s_in[c_], s_in[T::kPlane + c_], "
     "s_in[2 * T::kPlane + c_], fx[p]); }"),
    ("    easu<T, S, false>(s_in, (ry + 1) * T::kInW + rx + 1, rfx, rfy, sharp, mix, e);",
     "    { const int c_ = (ry + 1) * T::kInW + rx + 1;\n"
     "      for (int q = 0; q < S; ++q) e[q] = make_float4(s_in[c_], s_in[T::kPlane + c_], "
     "s_in[2 * T::kPlane + c_], rfx[q]); }"),
]
# fsr.cu as first ported (a thread per output pixel in RCAS, a loop over the
# ringed pixels in EASU): its RCAS loop and its EASU loop run no iteration
_FSR1_NO_RCAS = [("for (int i = tid; i < kOut * kOut; i += kThreads) {",
                  "for (int i = tid; i < 0; i += kThreads) {")]
_FSR1_NO_EASU = [("for (int i = tid; i < kRingPx; i += kThreads) {",
                  "for (int i = tid; i < 0; i += kThreads) {")]

# {library: ((variant, (alternative, ...)), ...)}; an alternative is the list
# of (text of the source, its replacement) for one design of the source: the
# first whose every text the source holds is applied
VARIANTS = {
    "fsr": (
        ("as built", ([],)),
        ("EASU only", (_FSR_NO_RCAS, _FSR1_NO_RCAS)),
        ("RCAS only", (_FSR_NO_EASU, _FSR1_NO_EASU)),
        ("loads only", (_FSR_NO_RCAS + _FSR_NO_EASU, _FSR1_NO_RCAS + _FSR1_NO_EASU)),
        ("no stores", (
            [("      store_row<S>(out + static_cast<size_t>(S * y + py) * ow + S * x, v);",
              "      unsigned x_ = 0;\n      for (int q = 0; q < S; ++q) x_ = x_ * 33u + v[q];\n"
              f"      if (x_ == {_RARE}) store_row<S>(out + static_cast<size_t>(S * y + py) * ow + S * x, v);")],
            [("    out[static_cast<size_t>(gy) * ow + gx] = make_uchar4(NU_RCAS(x), NU_RCAS(y), NU_RCAS(z), 255);",
              "    const uchar4 v_ = make_uchar4(NU_RCAS(x), NU_RCAS(y), NU_RCAS(z), 255);\n"
              f"    if (*reinterpret_cast<const unsigned*>(&v_) == {_RARE}) "
              "out[static_cast<size_t>(gy) * ow + gx] = v_;")],
        )),
    ),
    "soft_warp": (
        ("as built", ([],)),
        ("loads and conversions only", (
            [("  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));",
              "  return __fadd_rn(a, b);")],
        )),
        ("no stores", (
            [("    unsigned* o = reinterpret_cast<unsigned*>(out) + static_cast<size_t>(r - row0) * w + c0;\n",
              "    unsigned* o = reinterpret_cast<unsigned*>(out) + static_cast<size_t>(r - row0) * w + c0;\n"
              "    unsigned x_ = 0;\n    for (int j = 0; j < G; ++j) x_ = x_ * 33u + px[j];\n"
              f"    if (x_ != {_RARE}) continue;\n")],
            [("  out[static_cast<size_t>(r) * w + c] =\n"
              "      make_uchar4(pack_round(acc.x), pack_round(acc.y), pack_round(acc.z), pack_round(acc.w));",
              "  const uchar4 v_ =\n"
              "      make_uchar4(pack_round(acc.x), pack_round(acc.y), pack_round(acc.z), pack_round(acc.w));\n"
              f"  if (*reinterpret_cast<const unsigned*>(&v_) == {_RARE}) "
              "out[static_cast<size_t>(r) * w + c] = v_;")],
        )),
    ),
}


def apply(library: str, variant: str, alternatives, text: str) -> str:
    for subs in alternatives:
        if all(old in text for old, _ in subs):
            for old, new in subs:
                text = text.replace(old, new)
            return text
    raise RuntimeError(f"{library} variant {variant!r}: the source holds none of its texts")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a directory holding fsr.cu and soft_warp.cu of another commit")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fsr_soft_warp_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.kernels import fsr_cuda as fc
    from nu_scaler_tpu_torch.kernels import reference as ref
    from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
    from nu_scaler_tpu_torch.ops import interpolate as interp

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bench = chip_smoke.bench_frame(1080, 1920)
    a = torch.from_numpy(bench).to(dev)
    b = torch.from_numpy(np.roll(bench, 16, axis=1)).to(dev)
    n1, n2 = (torch.from_numpy(rng.integers(0, 256, (1080, 1920, 4), np.uint8)).to(dev) for _ in range(2))
    a720 = torch.from_numpy(chip_smoke.bench_frame(720, 1280)).to(dev)
    batch = torch.stack([a, b, n1, n2])
    sharp = ref.FSR_SHARPNESS["quality"]
    tile, k = interp.WARP_TILE, interp.SOFT_WARP_K
    motion = np.floor(rng.uniform(-20.0, 20.0, (1080 // tile[0], 1920 // tile[1], 2))) + 0.37
    soft_in = {
        "bench pair": (a, b, interp.flow_tiles_fast(a, b, tile)),
        "random motion": (n1, n2, torch.from_numpy(motion.astype(np.float32)).to(dev)),
    }
    soft_packed = {}
    for name, (fa, fb, tl) in soft_in.items():
        fin = swc.frame_inputs(tl, 0.5, k, interp.WARP_RANGE)
        soft_packed[name] = (fa, fb, fin, swc.pack_inputs(fin))
    inputs = {
        "fsr": {
            "1080p->4K s=2": lambda: fc._launch(a[None], 2, sharp),
            "720p->4K s=3": lambda: fc._launch(a720[None], 3, sharp),
            "N=4 1080p->4K s=2": lambda: fc._launch(batch, 2, sharp),
        },
        "soft_warp": {
            name: (lambda p=p: swc._launch(p[0], p[1], p[2], p[3], tile, k))
            for name, p in soft_packed.items()
        },
    }
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

    def use(library: str, tag: str, text: str) -> str:
        """Build `text` as `library` and load it in the wrappers' place;
        ptxas' registers and spill stores per kernel."""
        d = _build.BUILD_DIR / "probe" / re.sub(r"\W+", "_", tag)
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):  # the headers the source includes
            shutil.copy(header, d / header.name)
        (d / f"{library}.cu").write_text(text)
        _build.CSRC = d
        _build.load_library.cache_clear()
        _build.BUILD_LOGS.pop(library, None)
        _build.load_library(library)
        log = _build.BUILD_LOGS.get(library, "")
        if not log:
            return "built before this run"
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        return f"registers {regs}, spill stores {spills} bytes"

    sources = {"checkout": csrc}
    if args.baseline is not None:
        sources = {"baseline": args.baseline.resolve(), **sources}
    try:
        for library, variants in VARIANTS.items():
            texts = {src: (d / f"{library}.cu").read_text() for src, d in sources.items()}
            if len(sources) > 1:
                # the two as built, in turns: baseline, checkout, checkout, baseline
                order = ["baseline", "checkout", "checkout", "baseline"]
                for name, fn in inputs[library].items():
                    got = {src: [] for src in sources}
                    for src in order:
                        use(library, f"{library} {src} as built", texts[src])
                        got[src].append(time_ms(fn))
                    print(f"{library} [{name}] in turns (baseline, checkout, checkout, baseline): "
                          + ", ".join(f"{src} {np.mean(t):.4f} ms ({', '.join(f'{x:.4f}' for x in t)})"
                                      for src, t in got.items()), flush=True)
            for src in sources:
                for variant, alternatives in variants:
                    regs = use(library, f"{library} {src} {variant}",
                               apply(library, variant, alternatives, texts[src]))
                    times = {name: round(time_ms(fn), 4) for name, fn in inputs[library].items()}
                    print(f"{library} {src}, {variant}: ms {times} ({regs})", flush=True)
    finally:
        _build.CSRC = csrc
        _build.load_library.cache_clear()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=15)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
