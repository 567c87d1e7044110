"""Export the learned tier's serving checkpoints for the PyTorch port.

The port (`nu_scaler_tpu_torch`) imports neither JAX nor orbax, so it reads
its weights from numpy files committed inside its package. This tool
restores the orbax checkpoints the JAX package's learned ladders serve
(`nu_scaler_tpu.models.train.load_checkpoint`), and the seed-0
initialisations its ESRGANLite serves where no checkpoint exists
(`esrgan_lite.get_params` → `init_params(0, stages)`), and writes, per
checkpoint,

    nu_scaler_tpu_torch/weights/esrgan_{arch}_x{upscale}_{step}.npz
    nu_scaler_tpu_torch/weights/esrgan_{arch}_x{upscale}_{step}.json

(arch "lite" for ESRGANLite; step 0 and ``"init": "flax seed 0"`` in the
sidecar for an initialisation), and the learned interpolation refinement
nets (`nu_scaler_tpu.models.interp_refine` `load_checkpoint`: the step
`checkpoints/{net}/latest.txt` names): "interp_ref4", which mode
"flow_soft_ref" serves, and its wide distillation teacher "interp_ref4w", as

    nu_scaler_tpu_torch/weights/{net}_{step}.npz
    nu_scaler_tpu_torch/weights/{net}_{step}.json

The npz holds every parameter as float32 under its flax path joined by "/"
(``head/kernel``, ``block0/conv1/bias``, ...), exactly as restored. The JSON
sidecar records the arch, the stage count, the upscale, the model's keyword
arguments, the step and the npz's sha256, which the port checks on load, and,
under ``act_scales``, the checkpoint's int8 calibration (its
``act_scales.json``: ``{"step", "scales"}``) when that file's step equals the
exported step, as `nu_scaler_tpu.models.train.load_act_scales` requires
(for the refinement net `interp_refine.load_act_scales`, which reads
`checkpoints/interp_ref4/act_scales.json`). An
npz already on disk whose arrays equal the restore is kept as it is (its
bytes and sha256 do not move); only the sidecar is rewritten.

A checkpoint whose Adam state the JAX trainer saved beside it (the orbax
``{step}_opt`` tree: optax's ``ScaleByAdamState`` ``count``, ``mu``, ``nu``)
also gets

    nu_scaler_tpu_torch/weights/esrgan_{arch}_x{upscale}_{step}_opt.npz

(compressed; ``count`` as int32, ``mu/<flax path>`` and ``nu/<flax path>``
as float32), its sha256 in the checkpoint's sidecar under ``opt_sha256``:
the port's trainer restores the moments when it resumes from the export
(`nu_scaler_tpu_torch.models.train.load_export_opt_state`).

Run it where JAX and orbax are installed, from the root of the checkout:

    python tools/export_torch_weights.py
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "nu_scaler_tpu_torch" / "weights"

# (arch, stages, step the JAX package serves, model kwargs): every
# checkpoint under checkpoints/ that the JAX package reads. The "ultra",
# "quality" and "performance" ladders (esrgan_lite.py _ARCH_LADDER) serve
# tpu4b2 at x2, tpu4 at x2 (the "quality" ladder's int8 entry when tpu4b2 has
# no calibration at its step, and the teacher of `train --distill tpu4`) and
# x4 (there is no tpu4b2 x4 checkpoint), tpu4b1 at x2 (the head of
# "performance"), the stride-8 tpu8w and tpu8 at x2 (the "performance"
# ladder's next entries, and what `train --arch tpu8 / tpu8w` resumes from),
# the stride-2 tpu at x2 (frames stride 4 does not divide), and ESRGANLite
# ("lite"), the ladder's last resort: its checkpoint at x2, its seed-0
# initialisations at x4 and x8 (step 0). Each arch's kwargs are its orbax
# tree's shapes.
EXPORTS = (
    ("tpu4b2", 1, 76000, dict(stride=4, features=128, blocks=2)),
    ("tpu4", 1, 80000, dict(stride=4, features=128, blocks=3)),
    ("tpu4", 2, 52000, dict(stride=4, features=128, blocks=3)),
    ("tpu4b1", 1, 40000, dict(stride=4, features=128, blocks=1)),
    ("tpu8", 1, 40000, dict(stride=8, features=128, blocks=3)),
    ("tpu8w", 1, 60000, dict(stride=8, features=192, blocks=3)),
    ("tpu", 1, 12000, dict(stride=2, features=64, blocks=3)),
    ("lite", 1, 6000, dict(features=32, blocks=4)),
    ("lite", 2, 0, dict(features=32, blocks=4)),
    ("lite", 3, 0, dict(features=32, blocks=4)),
)
INIT = "flax seed 0"  # the sidecar's note on a step-0 export
# (net, step the JAX package serves, model kwargs): the refinement net of mode
# "flow_soft_ref" at the step its latest.txt names, and the wide distillation
# teacher its trainer reads (`train(distill=("interp_ref4w", 192, 2))`, the
# CLI's --distill-features / --distill-blocks defaults).
REFINE_EXPORTS = (
    ("interp_ref4", 112000, dict(features=128, blocks=1, stride=4)),
    ("interp_ref4w", 32000, dict(features=192, blocks=2, stride=4)),
)


def flatten(tree, prefix: str = "") -> dict:
    """Nested mapping of arrays → {"a/b/c": float32 array}, the "params"
    level dropped."""
    if "params" in tree and prefix == "":
        tree = tree["params"]
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if hasattr(val, "items"):
            flat.update(flatten(val, path + "/"))
        else:
            flat[path] = np.asarray(val, np.float32)
    return flat


def same_arrays(npz: Path, flat: dict) -> bool:
    """True when `npz` holds exactly `flat`: the same keys, bit for bit."""
    with np.load(npz) as z:
        return sorted(z.files) == sorted(flat) and all(
            z[k].dtype == flat[k].dtype and np.array_equal(z[k].view(np.uint32), flat[k].view(np.uint32))
            for k in flat)


def restore(arch: str, stages: int, step: int):
    """(params, step): the orbax checkpoint, or for step 0 ESRGANLite's
    seed-0 initialisation (`init_params(0, stages)`, what `get_params` serves
    without a checkpoint)."""
    from nu_scaler_tpu.models.esrgan_lite import init_params
    from nu_scaler_tpu.models.train import load_checkpoint

    if step == 0:
        if arch != "lite" or load_checkpoint(stages) is not None:
            raise ValueError(f"{arch} x{2 ** stages}: step 0 exports ESRGANLite's initialisation "
                             f"where the JAX package has no checkpoint")
        return init_params(0, stages)[1], 0
    restored = load_checkpoint(stages, arch)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint for {arch} x{2 ** stages}")
    return restored


def restore_opt(arch: str, stages: int, step: int):
    """The Adam state the JAX trainer saved beside checkpoint `step`, as
    {"count": int32, "mu/<path>": float32, "nu/<path>": float32}, or None
    when there is none."""
    import os

    import orbax.checkpoint as ocp
    from nu_scaler_tpu.models.train import ckpt_dir

    path = os.path.join(os.path.abspath(ckpt_dir(stages, arch)), f"{step}_opt")
    if step == 0 or not os.path.exists(path):
        return None
    adam_state = ocp.PyTreeCheckpointer().restore(path)[0]  # (ScaleByAdamState, EmptyState)
    flat = {"count": np.asarray(adam_state["count"], np.int32)}
    for moment in ("mu", "nu"):
        flat.update({f"{moment}/{k}": v for k, v in flatten(adam_state[moment]).items()})
    return flat


def write(stem: Path, params, meta: dict, scales, init: bool = False, opt=None) -> Path:
    """`stem`.npz (the flattened params; an equal npz on disk is kept) and
    `stem`.json (`meta`, the parameter count, the npz's sha256, with `init`
    the note on an initialisation and, when given, the int8 calibration of
    step meta["step"]); with `opt` (`restore_opt`) also `stem`_opt.npz,
    compressed, its sha256 in the sidecar."""
    flat = flatten(params)
    stem.parent.mkdir(parents=True, exist_ok=True)
    npz = stem.with_suffix(".npz")
    if not (npz.exists() and same_arrays(npz, flat)):
        np.savez(npz, **flat)
    meta = {
        **meta,
        "parameters": int(sum(a.size for a in flat.values())),
        "sha256": hashlib.sha256(npz.read_bytes()).hexdigest(),
    }
    if init:
        meta["init"] = INIT
    if scales is not None:
        meta["act_scales"] = {"step": meta["step"], "scales": scales}
    if opt is not None:
        opt_npz = stem.with_name(stem.name + "_opt.npz")
        if not (opt_npz.exists() and same_arrays(opt_npz, opt)):
            np.savez_compressed(opt_npz, **opt)
        meta["opt_sha256"] = hashlib.sha256(opt_npz.read_bytes()).hexdigest()
    stem.with_suffix(".json").write_text(json.dumps(meta, indent=1) + "\n")
    return npz


def export(arch: str, stages: int, step: int, kwargs: dict, out_dir: Path = OUT_DIR) -> Path:
    sys.path.insert(0, str(ROOT))
    from nu_scaler_tpu.models.train import load_act_scales

    params, got_step = restore(arch, stages, step)
    if got_step != step:
        raise ValueError(f"{arch} x{2 ** stages}: latest step is {got_step}, expected {step}")
    meta = {"arch": arch, "stages": stages, "upscale": 2 ** stages, "model": kwargs, "step": step}
    # the scales are None unless their step is `step`
    return write(out_dir / f"esrgan_{arch}_x{2 ** stages}_{step}", params, meta,
                 load_act_scales(stages, arch, step), init=step == 0,
                 opt=restore_opt(arch, stages, step))


def export_refine(net: str, step: int, kwargs: dict, out_dir: Path = OUT_DIR) -> Path:
    """The refinement net `net` at the step its latest.txt names, which must
    be `step`; its int8 calibration when act_scales.json has that step."""
    sys.path.insert(0, str(ROOT))
    from nu_scaler_tpu.models import interp_refine

    restored = interp_refine.load_checkpoint(net)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint for {net}")
    params, got_step = restored
    if got_step != step:
        raise ValueError(f"{net}: latest step is {got_step}, expected {step}")
    meta = {"net": net, "model": kwargs, "step": step}
    # act_scales.json lives beside the serving net only (interp_refine.CKPT_DIR)
    scales = interp_refine.load_act_scales(step) if net == "interp_ref4" else None
    return write(out_dir / f"{net}_{step}", params, meta, scales)


def main() -> int:
    npzs = [export(*e) for e in EXPORTS] + [export_refine(*e) for e in REFINE_EXPORTS]
    for npz in npzs:
        print(f"{npz.relative_to(ROOT)}: {npz.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
