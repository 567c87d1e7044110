"""kernels: `resample_fused.cu` in its blend form against its byte bound, in
%: the launches' bound (each input read once, each output written once, at
the memory rate) over their traced time."""

from portbench import yardstick
from portbench.trace import select


def read(ctx: dict):
    launches = select(ctx["record"], ("kernel",), name_has="resample_fused_kernel")
    cfg = ctx["cfg"]
    if not launches or "time_t" not in cfg:
        return None
    bound_s = yardstick.resample_blend_bytes(cfg) / yardstick.peaks(ctx["kind"])["hbm_bytes_s"]
    return 100.0 * len(launches) * bound_s / (sum(o["dur"] for o in launches) * 1e-6)
