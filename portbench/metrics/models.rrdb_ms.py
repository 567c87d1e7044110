"""models: device milliseconds of what the "realesrgan" ladder's `upscale_fn`
launches, per input frame."""

from portbench.trace import device_us

UNDER = "portbench.models.rrdb"


def read(ctx: dict):
    r = ctx["record"]
    us = device_us(r, under=UNDER)
    return us / 1e3 / r["frames_in"] if us > 0 else None
