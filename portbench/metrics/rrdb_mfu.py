"""device: the RRDBNet step's share of the card's dense fp16 peak, in %: the
model's operations a frame at its real widths, times the output frames a
second of the traced window, over the peak."""

from portbench import yardstick_rrdb


def read(ctx: dict):
    r, cfg = ctx["record"], ctx["cfg"]
    if "num_grow_ch" not in cfg or r["window_us"] <= 0 or r["frames_out"] == 0:
        return None
    fps = r["frames_out"] / (r["window_us"] * 1e-6)
    return 100.0 * yardstick_rrdb.ops_per_frame(cfg) * fps / yardstick_rrdb.fp16_peak(ctx["kind"])
