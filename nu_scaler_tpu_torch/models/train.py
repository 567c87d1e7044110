"""Training and checkpoints of the learned tier — the port of
`nu_scaler_tpu/models/train.py`.

Self-supervised super-resolution on area-downscaled crops of procedural
clips that went through the video path (`models/data.py` `PairPool`), or on
the synthetic gradients and blobs of `make_batch`. The step is
`esrgan_lite.make_train_step`: the module's fp32 forward, autograd, Adam with
`optax.adam`'s constants, under `esrgan_lite.fp32_training` (no TF32), on
the card unless the caller asks for the CPU. A step that fails raises; it
never moves to the CPU. Training on several cards (or several ranks of one)
uses the dp × tp sharded step, `esrgan_lite.make_sharded_train_step` on a
`parallel.mesh.make_2d_mesh`, one process a rank; `esrgan_lite.gather_model`
gives back the full module that `save_checkpoint` writes.

Checkpoints go under `CKPT_ROOT` (``checkpoints_torch/`` at the root of the
checkout, git-ignored), never under the JAX package's ``checkpoints/`` or the
port's committed ``nu_scaler_tpu_torch/weights/``:

    CKPT_ROOT/esrgan_{arch}_x{upscale}_{step}.npz     flax-named float32 arrays
    CKPT_ROOT/esrgan_{arch}_x{upscale}_{step}.json    arch, stages, upscale, model
                                                      kwargs, step, sha256 and,
                                                      once calibrated, act_scales
    CKPT_ROOT/esrgan_{arch}_x{upscale}_{step}_opt.pt  Adam's state
    CKPT_ROOT/esrgan_{arch}_x{upscale}_{step}_opt.npz a copied export's Adam
                                                      moments (``--calibrate``)

the format of `tools/export_torch_weights.py`. The API serves them: for each
arch and scale the learned ladders read the newest step in `CKPT_ROOT`
before the committed export (`esrgan_lite.weights_directory`), as JAX's read
the step its ``latest.txt`` names, so the next process (or one whose
loaders' caches are cleared) serves what a run saved; a "quant" ladder entry
serves int8 only when that step's sidecar holds its calibration
(``--calibrate``). ``--calibrate`` of the committed step first copies its
export (npz, sidecar and Adam moments) into `CKPT_ROOT` at that step and
writes the scales there, so the API serves that step in int8, as JAX serves
its committed step after its ``--calibrate``; the committed files are never
written.

Resume follows JAX's: the newest checkpoint of the arch in `CKPT_ROOT` (with
its Adam state), else the committed export of the arch in
``nu_scaler_tpu_torch/weights/``, which carries every checkpoint JAX
resumes from (tpu4b2 ×2 at 76000, tpu4 ×2 at 80000 and ×4 at 52000, tpu4b1
×2 at 40000, tpu8 ×2 at 40000, tpu8w ×2 at 60000, tpu ×2 at 12000, lite ×2 at
6000), else for tpu4b2 / tpu4b1 the next deeper arch's weights with its last
block dropped, else a seeded initialisation; a run saves at start + steps. A
resume from the export restores Adam's moments from the export's
``_opt.npz`` where it has one (tpu4b2 ×2, tpu4 ×2, tpu4b1 ×2, tpu4 ×4:
optax's ``count``, ``mu``, ``nu``, written by `tools/export_torch_weights.py`
from the orbax ``{step}_opt`` tree that JAX's resume restores), checked
against the sidecar's ``opt_sha256``. A distillation teacher (``--distill
tpu4``) resolves the same way: tpu4 ×2 at 80000 unless `CKPT_ROOT` holds a
tpu4 ×2 checkpoint.

Run (the card by default; ``--device cpu`` for the CPU):

    python -m nu_scaler_tpu_torch.models.train --arch tpu4b2 --steps 200
    python -m nu_scaler_tpu_torch.models.train --arch tpu4b2 --calibrate --io
    python -m nu_scaler_tpu_torch.models.train --arch tpu4b2 --eval
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.models import esrgan_lite as el

CKPT_ROOT = Path(__file__).resolve().parents[2] / "checkpoints_torch"

# the model keyword arguments of JAX's `make_model` (train.py:167-222) per
# arch; "lite" is ESRGANLite, the others ESRGANLiteTPU with the dense base
ARCHS = {
    "lite": dict(features=32, blocks=4),
    "tpu": dict(stride=2, features=64, blocks=3),
    "tpu4": dict(stride=4, features=128, blocks=3),
    "tpu4b2": dict(stride=4, features=128, blocks=2),
    "tpu4b1": dict(stride=4, features=128, blocks=1),
    "tpu8": dict(stride=8, features=128, blocks=3),
    "tpu8w": dict(stride=8, features=192, blocks=3),
}
# the warm start of an arch without weights of its own: the next deeper
# arch's, its last residual block dropped (train.py:292-309)
DONORS = {"tpu4b2": ("tpu4",), "tpu4b1": ("tpu4b2", "tpu4")}


def ckpt_stem(arch: str, stages: int, step: int) -> Path:
    """The path of a checkpoint in `CKPT_ROOT`, without its suffix."""
    return Path(CKPT_ROOT) / f"esrgan_{arch}_x{2 ** stages}_{step}"


def make_model(arch: str, stages: int, seed: int = 0) -> nn.Module:
    """The fp32 training module of `arch` at 2**stages, initialised by
    `esrgan_lite.init_module(·, seed)` (JAX's `make_model`, train.py:167,
    inits with `PRNGKey(0)`). Every ESRGANLiteTPU keeps the dense "conv"
    base, as JAX's training module does at every stride."""
    kw = ARCHS[arch]
    if arch == el.LITE:
        return el.init_params(seed, stages, **kw)
    return el.init_module(el.ESRGANLiteTPU(upscale=2 ** stages, **kw), seed)


def load_checkpoint(arch: str, stages: int, directory=None) -> Optional[tuple[nn.Module, int]]:
    """(the fp32 training module, its step) of the newest checkpoint of
    `arch` at 2**stages in `directory` (`CKPT_ROOT` by default), or None."""
    loaded = el.load_weights(arch, 2 ** stages, Path(CKPT_ROOT if directory is None else directory))
    if loaded is None:
        return None
    tree, meta = loaded
    model = make_model(arch, stages)
    model.load_state_dict(el.params_from_flax(tree))
    return model, int(meta["step"])


def load_latest(arch: str, stages: int) -> Optional[tuple[nn.Module, int, bool]]:
    """(module, step, from `CKPT_ROOT`) of the newest checkpoint of `arch` in
    `CKPT_ROOT`, else of the committed export; None when neither exists."""
    restored = load_checkpoint(arch, stages)
    if restored is not None:
        return (*restored, True)
    restored = load_checkpoint(arch, stages, el.WEIGHTS_DIR)
    return None if restored is None else (*restored, False)


def save_checkpoint(model: nn.Module, arch: str, stages: int, step: int,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> Path:
    """Write the checkpoint `esrgan_{arch}_x{upscale}_{step}` (npz and
    sidecar) and, with `optimizer`, its Adam state (`_opt.pt`) into
    `CKPT_ROOT`. Returns the npz's path."""
    stem = ckpt_stem(arch, stages, step)
    meta = {"arch": arch, "stages": stages, "upscale": 2 ** stages, "model": dict(ARCHS[arch]), "step": step}
    npz = el.write_weights(stem, model, meta)
    if optimizer is not None:
        torch.save(optimizer.state_dict(), stem.with_name(stem.name + "_opt.pt"))
    return npz


def load_opt_state(optimizer: torch.optim.Optimizer, arch: str, stages: int, step: int) -> bool:
    """Restore Adam's state saved beside the checkpoint at `step`; False
    when there is none or it does not fit the optimizer (re-initialised,
    as JAX's `load_opt_state`)."""
    stem = ckpt_stem(arch, stages, step)
    path = stem.with_name(stem.name + "_opt.pt")
    if not path.exists():
        return False
    try:
        optimizer.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    except ValueError:
        return False
    return True


def load_export_opt_state(optimizer: torch.optim.Optimizer, model: nn.Module, arch: str,
                          stages: int, step: int, directory=None) -> bool:
    """Restore Adam's state of the committed export at `step` (in
    `directory`: the committed `WEIGHTS_DIR` by default, or `CKPT_ROOT`
    holding its copy, `esrgan_lite.copy_export`) into `optimizer` (Adam over
    `model`'s parameters, `esrgan_lite.adam`): optax's ``ScaleByAdamState``
    mapped onto PyTorch's, ``count`` → each parameter's ``step``, ``mu`` →
    ``exp_avg``, ``nu`` → ``exp_avg_sq``, by the parameters' flax names.
    False when the export carries no moments; raises ValueError when the
    file's sha256 is not the sidecar's."""
    directory = el.WEIGHTS_DIR if directory is None else Path(directory)
    meta = el._sidecar(arch, 2 ** stages, directory)
    if meta is None or meta["step"] != step or "opt_sha256" not in meta:
        return False
    path = directory / f"esrgan_{arch}_x{2 ** stages}_{step}_opt.npz"
    tree = el.read_weights(path, meta["opt_sha256"])
    count = float(tree.pop("count"))
    moments = {m: el.params_from_flax(tree[m]) for m in ("mu", "nu")}
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": moments["mu"][name].to(p.device).reshape(p.shape),
            "exp_avg_sq": moments["nu"][name].to(p.device).reshape(p.shape),
        }
    return True


def _warm_start(model: nn.Module, arch: str, stages: int) -> None:
    """Copy the donor's layers whose names the module shares (head, the
    first blocks, trunk, tail) into `model`, as train.py:292-309 does."""
    for donor_arch in DONORS.get(arch, ()):
        donor = load_latest(donor_arch, stages)
        if donor is None:
            continue
        theirs = donor[0].state_dict()
        mine = model.state_dict()
        model.load_state_dict({k: theirs.get(k, v) for k, v in mine.items()})
        print(f"warm-started for {arch} from {donor_arch} step {donor[1]} (last block dropped)")
        return


def make_batch(rng: np.random.Generator, batch: int, size: int = 64, scale: int = 2):
    """(LR, HR): HR [N, size, size, 3] in [0, 1] (a gradient, 1-3 blobs and
    a hard edge), LR its `scale`× area downscale (train.py:136)."""
    n = batch
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    hr = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        img = np.zeros((size, size, 3), np.float32)
        a, b = rng.random(2)
        img += (a * xx + b * yy)[..., None] * rng.random(3)
        for _ in range(rng.integers(1, 4)):
            cx, cy = rng.random(2) * size
            s = 2 + rng.random() * 10
            blob = np.exp(-(((np.arange(size) - cx) / s) ** 2))[None, :] * np.exp(
                -(((np.arange(size) - cy) / s) ** 2))[:, None]
            img += blob[..., None] * rng.random(3)
        if rng.random() < 0.7:
            pos = rng.integers(4, size - 4)
            if rng.random() < 0.5:
                img[:, pos:] += rng.random(3) * 0.5
            else:
                img[pos:, :] += rng.random(3) * 0.5
        hr[i] = np.clip(img / max(img.max(), 1e-3), 0, 1)
    lr = hr.reshape(n, size // scale, scale, size // scale, scale, 3).mean(axis=(2, 4))
    return lr, hr


def make_distill_step(model: nn.Module, optimizer: torch.optim.Optimizer, loss_kind: str, w: float):
    """step(lr_b, hr_b, teacher_b) → (model, optimizer, loss) of
    (1 − w)·loss(student, HR) + w·loss(student, teacher(LR)), the teacher's
    outputs precomputed (train.py:225)."""
    fn = el.loss_of(loss_kind)

    def loss(lr_b, hr_b, t_b):
        pred = model(lr_b)
        return (1.0 - w) * fn(pred, hr_b) + w * fn(pred, t_b)

    return el.make_step(model, optimizer, loss)


def teacher_outputs(teacher_arch: str, stages: int, lrs: np.ndarray, device=None) -> np.ndarray:
    """The frozen teacher's predictions for every pool LR crop, in batches of
    64 on `device`: its newest checkpoint, else its committed export."""
    restored = load_latest(teacher_arch, stages)
    if restored is None:
        raise ValueError(f"no checkpoint for teacher arch {teacher_arch!r}")
    teacher, step, _ = restored
    print(f"distilling from {teacher_arch}@{step}", flush=True)
    dev = resolve_device(device)
    teacher.to(dev)
    outs = []
    with torch.no_grad(), el.fp32_training():
        for i in range(0, lrs.shape[0], 64):
            outs.append(teacher(torch.from_numpy(lrs[i: i + 64]).to(dev)).cpu().numpy())
    return np.concatenate(outs, axis=0)


def train(steps: int = 200, batch: int = 8, stages: int = 1, lr: float = 2e-4, seed: int = 0,
          log_every: int = 25, save: bool = True, arch: str = "lite", data: str = "video", crop: int = 96,
          loss_kind: str = "l1", n_clips: int = 12, pool_size: int = 4096, distill: Optional[str] = None,
          distill_w: float = 0.5, down_mix: float = 0.0, device=None) -> float:
    """One training leg on `device` (the card unless "cpu"); returns the
    final loss. data: "video" (`PairPool`: clip crops through the y4m path)
    or "synthetic" (`make_batch`). `distill`: a teacher arch, adding
    w·loss(student, teacher(LR)) on precomputed teacher outputs (video data
    only). One numpy generator seeded with `seed` draws the pool's crops,
    then each step's batch, in JAX's order. Saves at start + steps into
    `CKPT_ROOT`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    start, own = 0, False
    restored = load_latest(arch, stages)
    if restored is not None:
        model, start, own = restored
        print(f"resumed from step {start}" + ("" if own else " (the committed export)"))
    else:
        model = make_model(arch, stages)
        _warm_start(model, arch, stages)
    model.to(dev)
    opt = el.adam(model, lr)
    if own and load_opt_state(opt, arch, stages, start):
        print("restored optimizer state")
    elif restored is not None and load_export_opt_state(opt, model, arch, stages, start, CKPT_ROOT if own else None):
        # the export's moments, or those of its copy in CKPT_ROOT (`calibrate`)
        print("restored optimizer state (the committed export's)")
    if distill is not None:
        step_fn = make_distill_step(model, opt, loss_kind, distill_w)
    else:
        step_fn = el.make_train_step(model, opt, loss_kind)

    pool = touts = None
    if data == "video":
        from nu_scaler_tpu_torch.models.data import PairPool

        print("rendering clip pool (video path)...", flush=True)
        pool = PairPool(rng, scale=2 ** stages, crop=crop, n_clips=n_clips, pool_size=pool_size,
                        down_mix=down_mix)
        if distill is not None:
            touts = torch.from_numpy(teacher_outputs(distill, stages, pool.lrs, dev)).to(dev)
        # the pool stays on the device; a step takes only its indices
        lrs, hrs = torch.from_numpy(pool.lrs).to(dev), torch.from_numpy(pool.hrs).to(dev)
    elif distill is not None:
        raise ValueError("distillation needs data='video' (pooled crops)")

    loss = torch.tensor(float("nan"))
    t0 = time.time()
    for step in range(steps):
        if pool is not None:
            idx = torch.from_numpy(rng.integers(0, pool.hrs.shape[0], size=batch)).to(dev)
            args = (lrs[idx], hrs[idx]) + ((touts[idx],) if touts is not None else ())
        else:
            lr_b, hr_b = make_batch(rng, batch, scale=2 ** stages)
            args = (torch.from_numpy(lr_b).to(dev), torch.from_numpy(hr_b).to(dev))
        model, opt, loss = step_fn(*args)
        if step % log_every == 0:
            print(f"step {step:5d}  loss {float(loss):.5f}  ({time.time() - t0:.1f}s)", flush=True)
    print(f"final loss {float(loss):.5f}")
    if save:
        # the checkpoint's number is the total of training steps
        path = save_checkpoint(model, arch, stages, start + steps, opt)
        print(f"checkpoint: {path}")
    return float(loss)


def evaluate(stages: int = 1, arch: str = "tpu", device=None) -> dict:
    """Held-out PSNR / SSIM against the lanczos3 tier (`eval_vs_lanczos3`)
    of the newest checkpoint of `arch` (else its committed export, else a
    fresh init), its fp32 forward on `device`."""
    from nu_scaler_tpu_torch.models.data import eval_vs_lanczos3

    dev = resolve_device(device)
    restored = load_latest(arch, stages)
    if restored is not None:
        model, step, _ = restored
        print(f"evaluating checkpoint step {step}")
    else:
        model = make_model(arch, stages)
    model.to(dev)

    def fn(x: torch.Tensor) -> torch.Tensor:
        with el.fp32_training():
            return model(x)

    scores = eval_vs_lanczos3(fn, scale=2 ** stages, device=dev)
    for k, v in scores.items():
        print(f"  {k}: {v:.4f}")
    return scores


def calibrate(arch: str, stages: int = 1, io: bool = False, device=None) -> tuple[Path, dict]:
    """Calibrate the int8 activation scales of the newest checkpoint of
    `arch` (`load_latest`: in `CKPT_ROOT`, else the committed export, the
    step JAX's ``--calibrate`` calibrates) on training clips
    (`default_trunk_scales`) and write them into its sidecar in `CKPT_ROOT`.
    The committed export is first copied there at its step
    (`esrgan_lite.copy_export`, with its Adam moments, so a later resume is
    unchanged): the loaders then serve that step in int8 with these scales.
    With `io`, the head and base entries too (1.0 each: [0, 1] inputs),
    which the serving graph's int8 head and base read. Returns (the
    sidecar, the scales)."""
    if arch == el.LITE:
        raise ValueError("int8 calibration serves the s2d archs, not ESRGANLite")
    restored = load_latest(arch, stages)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint of {arch} x{2 ** stages} under {CKPT_ROOT} or {el.WEIGHTS_DIR}")
    model, step, own = restored
    model.to(resolve_device(device))
    scales = el.default_trunk_scales(model)
    if io:
        scales["head"] = 1.0
        scales["base"] = 1.0
    stem = ckpt_stem(arch, stages, step)
    if not own:
        el.copy_export(stem.name, CKPT_ROOT)
    path = el.write_sidecar_scales(stem.with_suffix(".json"), scales)
    return path, scales


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--stages", type=int, default=1)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--arch", default="lite", choices=sorted(ARCHS), help="resumes from the newest "
                   "checkpoint of the arch under CKPT_ROOT, else its committed export")
    p.add_argument("--data", default="video", choices=["video", "synthetic"])
    p.add_argument("--crop", type=int, default=96)
    p.add_argument("--loss", default="l1", choices=["l1", "l1_grad"])
    p.add_argument("--clips", type=int, default=12, help="clip-pool width (seeds 100..100+N-1; "
                   "eval seeds 900+ stay held out)")
    p.add_argument("--pool", type=int, default=4096, help="crop-pool size")
    p.add_argument("--distill", default=None, help="teacher arch to distill from (e.g. tpu4: its newest "
                   "checkpoint under CKPT_ROOT, else the committed export, tpu4 x2 at 80000); adds "
                   "w*loss(student, teacher(LR))")
    p.add_argument("--distill-w", type=float, default=0.5)
    p.add_argument("--down-mix", type=float, default=0.0, help="fraction of the clip pool rendered at "
                   "2x and area-downsampled (see PairPool)")
    p.add_argument("--seed", type=int, default=0, help="numpy seed of the pool draw and batch order")
    p.add_argument("--eval", action="store_true", help="evaluate the newest checkpoint against "
                   "lanczos3 on held-out clips and exit")
    p.add_argument("--calibrate", action="store_true", help="calibrate the int8 activation scales of "
                   "the newest checkpoint (training clips only) into its sidecar under CKPT_ROOT; the "
                   "committed export is copied there first")
    p.add_argument("--io", action="store_true", help="with --calibrate: also write the head and base "
                   "entries (the int8 head and base of the serving graph)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"], help="the card unless cpu")
    args = p.parse_args(argv)
    if args.calibrate:
        path, scales = calibrate(args.arch, args.stages, args.io, args.device)
        print(f"{args.arch} int8 scales -> {path}")
        for k, v in scales.items():
            print(f"  {k}: {v:.4f}")
    elif args.eval:
        evaluate(args.stages, args.arch, args.device)
    else:
        train(args.steps, args.batch, args.stages, args.lr, seed=args.seed, arch=args.arch, data=args.data,
              crop=args.crop, loss_kind=args.loss, n_clips=args.clips, pool_size=args.pool,
              distill=args.distill, distill_w=args.distill_w, down_mix=args.down_mix, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
