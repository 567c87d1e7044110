"""kernels: `conv3x3.cu` in its int8-grid mode (`conv3x3_q`) against its
roofline, in %: over the traced frames, the sum of each conv's bound (the
larger of its real-width operations over the int8 peak and its bytes over the
memory rate) over the launches' traced time. Silent unless the trace holds
one launch per conv per frame."""

import re

from portbench import yardstick
from portbench.trace import select

QGRID = re.compile(r"conv3x3_kernel<.*[ )]2>")


def read(ctx: dict):
    r, cfg = ctx["record"], ctx["cfg"]
    if "features" not in cfg:
        return None
    launches = [o for o in select(r, ("kernel",), name_has="conv3x3_kernel") if QGRID.search(o["name"])]
    if not launches or len(launches) != r["frames_in"] * len(yardstick.esrgan_convs(cfg)):
        return None
    bound_s = r["frames_in"] * yardstick.conv_q_bound_s(cfg, ctx["kind"])
    return 100.0 * bound_s / (sum(o["dur"] for o in launches) * 1e-6)
