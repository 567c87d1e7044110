"""The rank body of `tests/test_torch_sharded_train.py`'s world: a module of
its own, so that the spawned ranks import the port and not the JAX side."""

import torch
import torch.distributed as dist

from nu_scaler_tpu_torch.models import esrgan_lite as el
from nu_scaler_tpu_torch.parallel import mesh as pmesh
from nu_scaler_tpu_torch.parallel import tp


def _clone(named) -> dict:
    return {n: t.detach().clone() for n, t in named}


def run_cases(rank: int, dev, meshes, cases: dict, batch, steps: int, lr: float) -> dict:
    """On every mesh (d, m) of `meshes` and every case {tag: (arch, kwargs,
    state dict)}: the layout, the gathered module before any step, then
    `steps` sharded steps on `batch` (lr, hr), each with the loss, the local
    gradients, Adam's moments, the parameters and the collectives; and the
    ValueErrors of a mesh the world's size does not fit and of a batch the
    data axis does not divide. Returns {key: result}."""
    torch.set_num_threads(1)  # four ranks on a few shared cores: more threads only contend
    lr_b, hr_b = batch
    out = {}
    for d, m in meshes:
        mesh = pmesh.make_2d_mesh(d, m, dev)
        coords = (dist.get_rank(mesh.get_group("data")), dist.get_rank(mesh.get_group("model")))
        for tag, (arch, kwargs, state) in cases.items():
            model = (el.ESRGANLite if arch == "lite" else el.ESRGANLiteTPU)(**kwargs)
            model.load_state_dict(state)
            key = f"{d}x{m} {tag}"
            step, sharded, opt = el.make_sharded_train_step(model, lr, mesh)
            gathered = el.gather_model(sharded, mesh)
            rec = {"coords": coords, "layout": el.param_shardings(model, mesh),
                   "gathered": _clone(gathered.state_dict().items()),
                   "gathered_trainable": any(p.requires_grad for p in gathered.parameters()),
                   "on": str(next(sharded.parameters()).device), "steps": []}
            for _ in range(steps):
                tp.reset_collectives()
                _, _, loss = step(lr_b, hr_b)
                rec["steps"].append({
                    "loss": float(loss), "collectives": dict(tp.collectives),
                    "grads": {n: p.grad.clone() for n, p in sharded.named_parameters()},
                    "mu": {n: opt.state[p]["exp_avg"].clone() for n, p in sharded.named_parameters()},
                    "nu": {n: opt.state[p]["exp_avg_sq"].clone() for n, p in sharded.named_parameters()},
                    "params": _clone(sharded.named_parameters())})
            try:
                step(lr_b[:7], hr_b[:7])
                rec["odd_batch"] = "ran"
            except ValueError as e:
                rec["odd_batch"] = f"ValueError: {e}"
            out[key] = rec
    try:
        pmesh.make_2d_mesh(3, 1, dev)
        out["3x1"] = "built"
    except ValueError as e:
        out["3x1"] = f"ValueError: {e}"
    return out


def die_or_wait(rank: int, dev) -> None:
    """Rank 1 raises; rank 0 waits for it in a collective that never completes."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))
