"""The learned tier as the app's "dlss" request serves it:
`core.technologies.create_upscaler("dlss", quality)` → the advanced upscaler
on the learned ladder, initialised at the cell's sizes; its device function
`upscale_arr` is handed to `LivePipeline` as its `upscale_fn`.

What serves is pinned: the trainer's `CKPT_ROOT` points at an empty
directory of the run's own, so no checkpoint left on the machine can serve,
and the served arch, step, int8 graph, directory and the npz's sha256 must be
the configuration's, or set-up fails.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

SPANS = {"upscale_fn": "portbench.models.learned"}
ROOT = Path(__file__).resolve().parents[2]


def build(cfg: dict, device, scratch: Path) -> dict:
    from nu_scaler_tpu_torch.core.technologies import create_upscaler
    from nu_scaler_tpu_torch.models import train

    ckpt_root = Path(scratch) / "ckpt_root"
    ckpt_root.mkdir(parents=True, exist_ok=False)
    train.CKPT_ROOT = ckpt_root
    up = create_upscaler("dlss", cfg["quality"], device=device)
    up.initialize(cfg["in_w"], cfg["in_h"], cfg["out_w"], cfg["out_h"])
    served = up._fn
    npz = ROOT / cfg["weights"]
    found = {"arch": getattr(served, "arch", None), "step": getattr(served, "step", None),
             "quantized": getattr(served, "quantized", None),
             "directory": str(Path(getattr(served, "directory", "")).resolve())}
    want = {"arch": cfg["arch"], "step": cfg["step"], "quantized": True,
            "directory": str(npz.parent.resolve())}
    if found != want:
        raise RuntimeError(f"the learned tier serves {found}, not the configuration's {want}")
    digest = hashlib.sha256((Path(found["directory"]) / npz.name).read_bytes()).hexdigest()
    if digest != cfg["sha256"]:
        raise RuntimeError(f"the served {npz.name} has sha256 {digest}, not {cfg['sha256']}")
    return {"upscale_fn": up.upscale_arr}


def payloads_per_frame(cfg: dict, index: int) -> int:
    return 1
