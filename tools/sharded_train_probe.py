"""Run `chip_smoke.py`'s phase 4m (the dp × tp train step,
`models/esrgan_lite.py` `make_sharded_train_step` on `parallel/mesh.py`
`make_2d_mesh`) alone. On one card: the 2 × 2 step on 4 gloo ranks that
share cuda:0 against one card's step, the gathered weights served through
conv3x3.cu, and a 1 × 1 NCCL world. On four or more cards also the 2 × 2
step on NCCL across cuda:0..3 with the same gates: what one card cannot
check, since NCCL refuses two ranks on one card.

Run from the root of a checkout:

    python3 tools/sharded_train_probe.py

It prints the cards (name, power limit), phase 4m's report and last one
JSON line {"ok": ..., "cards": N, "launches": {...}}; it exits non-zero
without a card or when a check fails.
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

    if not torch.cuda.is_available():
        print("sharded_train_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.models import data as pdata

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=15, check=True)
    cards = smi.stdout.strip().splitlines()
    print(f"cards: {cards}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    cs.set_tf32(torch, False)
    _build.build(tuple(_build.SIGNATURES))
    t = cs.TRAIN
    # phase 4k's pool: its first draw from default_rng(SEED)
    pool = pdata.PairPool(np.random.default_rng(cs.SEED), scale=2, crop=t["crop"], n_clips=t["n_clips"],
                          pool_size=t["pool_size"])
    frame = cs.make_frames(np.random.default_rng(cs.SEED))["a"]
    with cs.Phase("4m sharded training"):
        counts, _ = cs.sharded_training_on_the_card(torch, cards[0], torch.device("cuda", 0), pool, frame)
        cs.check(torch.cuda.current_device() == 0, "a launch left the caller on another device")
    print(json.dumps({"ok": True, "cards": torch.cuda.device_count(), "launches": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
