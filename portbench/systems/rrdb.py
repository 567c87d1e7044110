"""The "realesrgan" ladder as the advanced upscaler serves it:
`PyAdvancedWgpuUpscaler("ultra")` with ``learned_prefer = "realesrgan"``,
initialised at the cell's sizes; its `upscale_arr` is handed to
`LivePipeline` as its `upscale_fn`.

What serves is pinned: the trainer's `CKPT_ROOT` points at an empty
directory of the run's own, into which the configuration's seeded weights
are written (`reference/rrdbnet.py` `seeded_state`, `write_checkpoint`); the
served arch, step and directory and the npz's sha256 must be the
configuration's, or set-up fails.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

from portbench.reference.rrdbnet import seeded_state, write_checkpoint

SPANS = {"upscale_fn": "portbench.models.rrdb"}


def build(cfg: dict, device, scratch: Path) -> dict:
    from nu_scaler_tpu_torch.core.upscaler import PyAdvancedWgpuUpscaler
    from nu_scaler_tpu_torch.models import train

    ckpt_root = Path(scratch) / "ckpt_root"
    ckpt_root.mkdir(parents=True, exist_ok=False)
    npz = write_checkpoint(seeded_state(cfg), ckpt_root, cfg)
    train.CKPT_ROOT = ckpt_root
    up = PyAdvancedWgpuUpscaler("ultra", "bilinear", True, device)
    up.learned_prefer = "realesrgan"
    up.initialize(cfg["in_w"], cfg["in_h"], cfg["out_w"], cfg["out_h"])
    served = up._fn
    found = {"arch": getattr(served, "arch", None), "step": getattr(served, "step", None),
             "directory": str(Path(getattr(served, "directory", "")).resolve())}
    want = {"arch": cfg["arch"], "step": cfg["step"], "directory": str(ckpt_root.resolve())}
    if found != want:
        raise RuntimeError(f"the realesrgan ladder serves {found}, not the configuration's {want}")
    digest = hashlib.sha256((Path(found["directory"]) / npz.name).read_bytes()).hexdigest()
    if digest != cfg["sha256"]:
        raise RuntimeError(f"the served {npz.name} has sha256 {digest}, not {cfg['sha256']}")
    return {"upscale_fn": up.upscale_arr}


def payloads_per_frame(cfg: dict, index: int) -> int:
    return 1
