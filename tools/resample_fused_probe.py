"""Split the fused resample kernel's time on an NVIDIA card.

Times `nu_scaler_tpu_torch/kernels/csrc/resample_fused.cu` at 1080p→4K
lanczos3 as it is, then source variants with one part of each tile's work
switched off (the horizontal pass, the vertical pass, both, the global
stores), then the kernel under other launch bounds at several tiles. Each
variant is built like the package's library (`kernels/_build.py`, one
`nvcc`) from a copy of the source under `build/nu_scaler_tpu_torch/probe/`.
A variant that skips a pass gives wrong bytes; only the timings mean
anything. The tiles and launch bounds give the kernel's bytes, and the
script checks that.

Run from the root of a checkout, on a machine with a card and `nvcc`:

    python3 tools/resample_fused_probe.py

Prints one line per variant (median of 20 CUDA-event timings, the L2 cache
flushed before each, as chip_smoke.py times), then the card's name and power
limit. Exits non-zero without a card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (name, [(text of the source, its replacement)])
PARTS = (
    ("as built", []),
    ("no horizontal pass", [("wi < row_sets * qblocks;", "wi < 0;")]),
    ("no vertical pass", [("i < runs * g.fc;", "i < 0;")]),
    ("loads only", [("wi < row_sets * qblocks;", "wi < 0;"), ("i < runs * g.fc;", "i < 0;")]),
    # the stores kept behind a test the data never passes
    ("no global stores", [("    *reinterpret_cast<uint4*>(dst + o) = px;",
                           "    if (px.x == 0x12345678u && px.y == 0x9abcdef0u) "
                           "*reinterpret_cast<uint4*>(dst + o) = px;")]),
)
TILES = ((64, 128), (32, 128), (64, 64), (32, 64))
BOUNDS = (2, 3, 4)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("resample_fused_probe: no CUDA device", file=sys.stderr)
        return 1
    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc
    from nu_scaler_tpu_torch.ops import resample

    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1080, 1920, 4), np.uint8)).to(dev)
    plan = resample.make_resampler(1080, 1920, 2160, 3840, "lanczos3", dev).plan
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    source = _build.source_path("resample_fused").read_text()
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

    def use(name: str, text: str) -> str:
        """Build `text` as the resample library and load it; nvcc's
        registers and spill stores per kernel."""
        d = _build.BUILD_DIR / "probe" / re.sub(r"\W+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):  # the headers the source includes
            shutil.copy(header, d / header.name)
        (d / "resample_fused.cu").write_text(text)
        _build.CSRC = d
        _build.load_library.cache_clear()
        _build.load_library("resample_fused")
        log = _build.BUILD_LOGS.get("resample_fused", "")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        if not log:
            return "built before this run"
        return f"registers {regs}, spill stores {spills} bytes"

    try:
        want = None
        for name, subs in PARTS:
            text = source
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"variant {name!r}: the source no longer holds {old!r}")
                text = text.replace(old, new)
            regs = use(name, text)
            fn = lambda: rc._launch(x, 1, plan)  # noqa: E731
            if want is None:
                want = fn()[0].clone()
            print(f"resample_fused 1080p->4K lanczos3, {name}: {time_ms(fn):.4f} ms ({regs})", flush=True)
        for bound in BOUNDS:
            text = source.replace("__launch_bounds__(kThreads, 2)", f"__launch_bounds__(kThreads, {bound})")
            regs = use(f"bounds {bound}", text)
            times = {}
            for tile in TILES:
                tiling = plan.tiling(tile)
                if not torch.equal(rc._launch(x, 1, plan, tiling=tiling)[0], want):
                    raise RuntimeError(f"launch bounds {bound}, tile {tile}: other bytes")
                times[str(tile)] = round(time_ms(lambda: rc._launch(x, 1, plan, tiling=tiling)), 4)
            print(f"resample_fused __launch_bounds__(256, {bound}) ({regs}): ms by tile {times}", flush=True)
    finally:
        _build.CSRC = csrc
        _build.load_library.cache_clear()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=15)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
