"""ops (`resample.py`): device milliseconds of what the fused resample +
cross-fade step launches, per input frame."""

from portbench.trace import device_us


def read(ctx: dict):
    r = ctx["record"]
    us = device_us(r, under="portbench.ops.blend_step")
    return us / 1e3 / r["frames_in"] if us > 0 else None
