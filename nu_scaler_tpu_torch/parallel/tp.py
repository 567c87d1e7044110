"""The collectives of the dp × tp train step (`models/esrgan_lite.py`
`make_sharded_train_step`), on `torch.distributed` over a 2-D
`DeviceMesh` with dims ("data", "model") (`parallel/mesh.py`
`make_2d_mesh`).

A conv whose output channels are split over "model" is column-parallel: its
input is replicated on every model rank and each rank computes its own
channels. Around it:

* `copy_to_model`: the identity in the forward; in the backward the sum of
  the input's gradient over "model", since each rank's gradient holds only
  its own output channels' share;
* `gather_channels`: the ranks' outputs concatenated on the last (channel)
  axis of NHWC in the forward, so everything after the conv runs replicated;
  in the backward the rank's own slice of the gradient, without a sum (the
  replicated graph downstream gives every model rank the same gradient).

`all_reduce` is the one reduction of the step, also the data-parallel mean of
the gradients. Each collective adds one to its count in `collectives`
(`reset_collectives` sets them to 0). A group of one rank needs none: the
callers skip them there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

collectives = {"all_reduce": 0, "all_gather": 0}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, in place; returns `x`."""
    collectives["all_reduce"] += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated on the last axis, in group-rank order."""
    collectives["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


def rank_device(mesh) -> torch.device:
    """This rank's device on `mesh`: the current CUDA device for a "cuda"
    mesh (`mesh.world` sets it), else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.width, ctx.rank = y.shape[-1], dist.get_rank(group)
        return all_gather_last(y, group)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo: lo + ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Before a column-parallel conv: `x` as is; its gradient summed over `group`."""
    return _CopyToModel.apply(x, group)


def gather_channels(y: torch.Tensor, group) -> torch.Tensor:
    """After a column-parallel conv: the full channels from every rank of
    `group`; the gradient is the rank's own slice."""
    return _GatherChannels.apply(y, group)
