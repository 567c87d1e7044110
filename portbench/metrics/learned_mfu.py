"""device: the learned step's share of the card's int8 peak, in %: the
model's operations a frame at the checkpoint's real widths, times the output
frames a second of the traced window, over the int8 dense peak."""

from portbench import yardstick


def read(ctx: dict):
    r, cfg = ctx["record"], ctx["cfg"]
    if "features" not in cfg or r["window_us"] <= 0 or r["frames_out"] == 0:
        return None
    fps = r["frames_out"] / (r["window_us"] * 1e-6)
    return 100.0 * yardstick.esrgan_ops_per_frame(cfg) * fps / yardstick.peaks(ctx["kind"])["int8_ops_s"]
