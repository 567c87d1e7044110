"""The 95th percentile (nearest rank) over every frame put in the window
whose payloads were all host arrays before it closed, from the start of its
`put` to the end of the `put` that returned them."""

from portbench.window import p95


def read(ctx: dict):
    return p95(ctx["window"].latencies_ms())
