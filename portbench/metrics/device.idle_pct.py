"""device: the share of the traced window in which no kernel, copy or memset
ran on the card, in %."""


def read(ctx: dict):
    r = ctx["record"]
    return 100.0 * (1.0 - r["busy_us"] / r["window_us"]) if r["window_us"] > 0 else None
