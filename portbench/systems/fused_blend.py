"""The classical path as the program serves it: the fused resample +
cross-fade step (`ops.resample.make_fused_blend`), one launch a step, handed
to `LivePipeline` as its `fused_step_fn`."""

from __future__ import annotations

SPANS = {"fused_step_fn": "portbench.ops.blend_step"}


def build(cfg: dict, device, scratch) -> dict:
    from nu_scaler_tpu_torch.ops.resample import make_fused_blend

    ts = tuple(cfg["time_t"])
    step = make_fused_blend(cfg["in_h"], cfg["in_w"], cfg["out_h"], cfg["out_w"], cfg["algorithm"],
                            ts if len(ts) > 1 else ts[0], device)
    return {"fused_step_fn": step}


def payloads_per_frame(cfg: dict, index: int) -> int:
    """The first frame of a stream gives its upscale; every later one its
    mids and its upscale."""
    return 1 if index == 0 else len(cfg["time_t"]) + 1
