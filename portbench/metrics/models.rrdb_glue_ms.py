"""models: device milliseconds a frame of what the "realesrgan" ladder's
`upscale_fn` launches that is not a convolution: elementwise passes (the
convs' bias adds, LeakyReLU, residual adds, the input and output
conversions), the concatenations of the dense connections, copies, layout
transforms, nearest upsampling, memsets and memcpys. Names as an H100's
trace gives them (PyTorch 2.11, cuDNN 9.2): every other operation is taken
for a convolution, whatever implements it."""

from portbench.trace import select

UNDER = "portbench.models.rrdb"
GLUE_NAMES = ("elementwise", "CatArrayBatchedCopy", "upsample", "copy", "gather", "scatter",
              "reduce", "nchwToNhwc", "nhwcToNchw", "transpose", "fill")


def is_glue(op: dict) -> bool:
    return op["cat"] != "kernel" or any(k in op["name"] for k in GLUE_NAMES)


def read(ctx: dict):
    r = ctx["record"]
    ops = select(r, under=UNDER)
    if not ops:
        return None
    return sum(o["dur"] for o in ops if is_glue(o)) / 1e3 / r["frames_in"]
