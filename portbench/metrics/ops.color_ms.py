"""ops (`color.py`): device milliseconds of what the 4:2:0 ingest and
delivery converters launch, per input frame."""

from portbench.trace import device_us


def read(ctx: dict):
    r = ctx["record"]
    us = device_us(r, under="portbench.ops.color.")
    return us / 1e3 / r["frames_in"] if us > 0 else None
