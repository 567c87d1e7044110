"""runtime: device milliseconds of host-to-device copies, per input frame."""

from portbench.trace import device_us


def read(ctx: dict):
    r = ctx["record"]
    us = device_us(r, ("gpu_memcpy",), name_has="HtoD")
    return us / 1e3 / r["frames_in"] if us > 0 else None
