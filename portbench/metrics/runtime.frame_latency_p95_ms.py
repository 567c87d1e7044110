"""runtime: the frame latency's 95th percentile (nearest rank), as the
end-to-end `frame_latency_p95_ms` defines it, in the cells whose tail swings
too far from run to run to hold an end-to-end bound. The frames put under
the profiler are left out: the rest of the traced run's window is untraced."""

from portbench.window import p95


def read(ctx: dict):
    return p95(ctx["window"].latencies_ms(skip=ctx["traced_steps"]))
