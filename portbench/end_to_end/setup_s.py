"""Seconds from the process's start to the window's start: imports, the
card, the inputs, the program's step built (the kernels compiled on a
checkout's first run) and the cell's shapes warmed up."""


def read(ctx: dict):
    return ctx["setup_s"]
