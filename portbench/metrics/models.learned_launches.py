"""models: kernel launches under the learned tier's `upscale_fn`, per input
frame (a count)."""

from portbench.trace import select


def read(ctx: dict):
    r = ctx["record"]
    n = len(select(r, ("kernel",), under="portbench.models.learned"))
    return n / r["frames_in"] if n else None
