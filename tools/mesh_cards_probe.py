"""Run `chip_smoke.py`'s phase 4l (the mesh, `nu_scaler_tpu_torch/parallel/mesh.py`)
alone on a machine with several cards: every mesh function on 4 shards of
cuda:0 and on the mesh of every visible card (and the 2- and 3-card meshes of
the shapes that need them), each result byte-equal to one call on cuda:0, the
API's `upscale_batch` through the unpatched `default_mesh` (all the cards),
and the sharded calls' CUDA-event times beside one call's. It checks what one
card cannot: the copies between cards, each shard's kernels on its own card,
and the caller's device left as it was.

Run from the root of a checkout, on two or more cards:

    python3 tools/mesh_cards_probe.py

It prints the cards (name, power limit), phase 4l's report and times, and
last one JSON line {"ok": ..., "cards": N, "launches": {...}}; it exits
non-zero with fewer than two cards or when a check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if torch.cuda.device_count() < 2:
        print(f"mesh_cards_probe: {torch.cuda.device_count()} CUDA device(s); it needs two or more",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.kernels import reference as ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=15, check=True)
    cards = smi.stdout.strip().splitlines()
    print(f"cards: {cards}", flush=True)
    cs.set_tf32(torch, False)
    _build.build(tuple(_build.SIGNATURES))
    frames = cs.make_frames(np.random.default_rng(cs.SEED))
    wv = torch.from_numpy(ref.filter_weights(cs.IN_H, cs.OUT_H, "lanczos3")).cuda().double()
    wh = torch.from_numpy(ref.filter_weights(cs.IN_W, cs.OUT_W, "lanczos3")).cuda().double()
    golden_a = cs.golden(torch, frames["a"], wv, wh).cpu().numpy()
    dev = torch.device("cuda", 0)
    with cs.Phase("4l mesh on every card"):
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # time_ms's L2 flush
        counts, _ = cs.mesh_on_the_card(torch, cards[0], dev, frames, golden_a,
                                        cs.bench_frame(*cs.SIZES["540p"]), flush)
        cs.check(torch.cuda.current_device() == 0, "a launch left the caller on another device")
    print(json.dumps({"ok": True, "cards": torch.cuda.device_count(), "launches": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
