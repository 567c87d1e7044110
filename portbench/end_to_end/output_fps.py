"""Output frames that reached host memory during the window, over the
window's seconds."""


def read(ctx: dict):
    return ctx["window"].output_fps()
