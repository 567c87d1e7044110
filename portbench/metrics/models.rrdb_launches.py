"""models: device operations (kernels, copies, memsets) under the
"realesrgan" ladder's `upscale_fn`, per input frame (a count)."""

from portbench.trace import select


def read(ctx: dict):
    r = ctx["record"]
    n = len(select(r, under="portbench.models.rrdb"))
    return n / r["frames_in"] if n else None
