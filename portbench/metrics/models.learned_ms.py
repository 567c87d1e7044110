"""models: device milliseconds of what the learned tier's `upscale_fn`
launches, per input frame."""

from portbench.trace import device_us


def read(ctx: dict):
    r = ctx["record"]
    us = device_us(r, under="portbench.models.learned")
    return us / 1e3 / r["frames_in"] if us > 0 else None
