"""Reduce a `torch.profiler` chrome trace to the record the per-layer metrics
read.

The benchmark wraps each function it hands to the pipeline in a
`record_function` range named ``portbench.<layer>...`` and the traced steps
in ``portbench.window``. A device operation (kernel, copy or memset) belongs
to every range that contains, on the host, the runtime call that launched it
(matched by the trace's correlation id).
"""

from __future__ import annotations

import json
from bisect import bisect_right

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
TOP = 10


def load_events(path) -> list[dict]:
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(spans: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] covered by the union of `spans`."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in _union(spans))


def idle_gaps(spans: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    gaps, t = [], lo
    for a, b in _union(spans):
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def _host_label(host: list[dict], starts: list[float], t: float) -> str:
    """The innermost host event that covers time `t` (the latest-starting
    one that has not ended), or a label for plain Python."""
    for ev in reversed(host[: bisect_right(starts, t)]):
        if ev["ts"] + ev["dur"] >= t:
            return ev["name"]
    return "host outside any traced call"


def reduce(events: list[dict], frames_in: int, frames_out: int) -> dict:
    """The record of one traced window: its length and busy time, every device
    operation with the benchmark's ranges it was launched under, the steps and
    outputs in it, and the breakdown (largest device operations by name,
    longest idle gaps by what the host was doing)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW!r} range")
    win = windows[0]
    lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    spans = [e for e in xs if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX) and e["name"] != WINDOW]
    launch_ts = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = (float(e["ts"]), e.get("tid"))
    ops = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        if a + d <= lo or a >= hi:
            continue
        launched = launch_ts.get((e.get("args") or {}).get("correlation"))
        ranges = sorted({s["name"] for s in spans if launched is not None
                         and s.get("tid") == launched[1]
                         and s["ts"] <= launched[0] <= s["ts"] + s["dur"]})
        ops.append({"name": e["name"], "cat": e["cat"], "ts": a, "dur": d, "ranges": ranges})
    dev_spans = [(o["ts"], o["ts"] + o["dur"]) for o in ops]
    busy = busy_us(dev_spans, lo, hi)

    by_name: dict[str, float] = {}
    for o in ops:
        by_name[o["name"]] = by_name.get(o["name"], 0.0) + o["dur"]
    host = sorted((e for e in xs if e.get("cat") in HOST_CATS and e.get("tid") == win.get("tid")
                   and e is not win), key=lambda e: e["ts"])
    starts = [float(e["ts"]) for e in host]
    by_host: dict[str, float] = {}
    for a, b in idle_gaps(dev_spans, lo, hi):
        label = _host_label(host, starts, (a + b) / 2)
        by_host[label] = by_host.get(label, 0.0) + (b - a)
    top = lambda d: [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "window_us": hi - lo,
        "busy_us": busy,
        "frames_in": frames_in,
        "frames_out": frames_out,
        "ops": ops,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(by_host)},
    }


def device_us(record: dict, cats=DEVICE_CATS, under: str = "", name_has: str = "") -> float:
    """Device microseconds of the record's operations of `cats`, launched under
    a range that starts with `under`, whose name contains `name_has`."""
    return sum(o["dur"] for o in select(record, cats, under, name_has))


def select(record: dict, cats=DEVICE_CATS, under: str = "", name_has: str = "") -> list[dict]:
    return [o for o in record["ops"] if o["cat"] in cats and name_has in o["name"]
            and (not under or any(r.startswith(under) for r in o["ranges"]))]
