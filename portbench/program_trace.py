"""The program's own spans (`nu_scaler_tpu_torch.utils.tracing`, ``nu.``
names) read for a cell, and a command that measures them on the card:

    python3 -m portbench.program_trace --workload <name> --seed <n> --seconds <s>

One run builds the cell as `run.py` does (the same clip, step, link and
``portbench.`` ranges) with the tracer on from the process's start, so the
set-up spans are caught; then:

1. the tracer on, a `torch.profiler` window of the mix's `traced_steps`
   steps: the device trace, each operation under the ``nu.`` ranges its
   launch ran in (`reduce_program`);
2. the profiler off, `--seconds` of steps with the tracer off and
   `--seconds` with it on, in `ROUNDS` turns: the spans of the tracer-on
   turns are what the host-clock readings read, and the two sides' rates
   are what the tracer costs.

The last line of standard output is one JSON object: `readings` (each of
`READERS` that found something to read), `program_breakdown` (idle time of
the card by the host's innermost ``nu.`` span, device ms a frame by learned
stage, host self time a put by span), `tracer_cost` (each turn's rate and median put, by side),
`kernel_loads_in_window` (libraries loaded or built after set-up),
`setup_s` and `device`. With no card it exits non-zero and prints no
result.

A reader gives None where its spans are absent, where the tracer dropped
records, and (the learned readers) where a call of the learned graph lacks
one of its seven stage spans.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import sys
import tempfile
import time
from bisect import bisect_right
from pathlib import Path

from portbench import registry, run, trace

LEARNED = "nu.models.learned"
STAGES = ("s2d", "head", "blocks", "trunk", "tail", "base", "assemble")
FETCH = "nu.runtime.fetch"
CONV = "conv3x3_kernel"
OUTSIDE = "host outside any nu. span"
TOP = 12
ROUNDS = 3  # tracer-off and tracer-on segments, in turns


# ---- the device trace of step 2 ---------------------------------------------------------------

def _paths(ranges: list[dict], lo: float, hi: float) -> list[tuple[float, float, tuple]]:
    """[lo, hi] cut into segments, each with the names of the ranges that
    cover it, outermost first (one thread's ranges nest)."""
    segs: list = []
    stack: list = []  # (end, name), innermost last
    t = lo

    def advance(to: float) -> None:
        nonlocal t
        while stack and stack[-1][0] <= to:
            end = stack[-1][0]
            if end > t:
                segs.append((t, end, tuple(n for _, n in stack)))
                t = end
            stack.pop()
        if to > t:
            segs.append((t, to, tuple(n for _, n in stack)))
            t = to

    for r in sorted(ranges, key=lambda r: (r["ts"], -r["dur"])):
        a = float(r["ts"])
        if a >= hi:
            break
        advance(min(max(a, lo), hi))
        stack.append((a + float(r["dur"]), r["name"]))
    advance(hi)
    return segs


def _path_at(segs: list, starts: list, t: float) -> tuple:
    i = bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and segs[i][0] <= t < segs[i][1] else ()


def reduce_program(events: list[dict], frames_in: int) -> dict:
    """The record of a traced window with the program's ranges: its length
    and busy time, each device operation with the ``nu.`` ranges its launch
    ran in (`path`, outermost first), the card's idle time by the host's
    innermost ``nu.`` range (`idle_by_span`, us), and each learned call's
    stage ranges."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == trace.WINDOW]
    if not wins:
        raise ValueError(f"the trace holds no {trace.WINDOW!r} range")
    win = wins[0]
    lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    ranges = [e for e in xs if e.get("cat") == "user_annotation" and e.get("tid") == win.get("tid")
              and str(e.get("name", "")).startswith("nu.")]
    segs = _paths(ranges, lo, hi)
    starts = [s[0] for s in segs]
    launch = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (float(e["ts"]), e.get("tid"))
    ops = []
    for e in xs:
        if e.get("cat") not in trace.DEVICE_CATS:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        if a + d <= lo or a >= hi:
            continue
        at = launch.get((e.get("args") or {}).get("correlation"))
        path = _path_at(segs, starts, at[0]) if at is not None and at[1] == win.get("tid") else ()
        ops.append({"name": e["name"], "cat": e["cat"], "ts": a, "dur": d, "path": path})
    dev = [(o["ts"], o["ts"] + o["dur"]) for o in ops]
    idle: dict[str, float] = {}
    for a, b in trace.idle_gaps(dev, lo, hi):
        i = max(0, bisect_right(starts, a) - 1)
        while i < len(segs) and segs[i][0] < b:
            s0, s1, path = segs[i]
            cut = min(b, s1) - max(a, s0)
            if cut > 0:
                label = path[-1] if path else OUTSIDE
                idle[label] = idle.get(label, 0.0) + cut
            i += 1
    calls = []
    for r in ranges:
        if r["name"] == LEARNED:
            a, b = float(r["ts"]), float(r["ts"]) + float(r["dur"])
            calls.append(sorted(x["name"][len(LEARNED) + 1:] for x in ranges
                                if x["name"].startswith(LEARNED + ".") and a <= x["ts"] <= b))
    return {"window_us": hi - lo, "busy_us": trace.busy_us(dev, lo, hi), "frames_in": frames_in,
            "ops": ops, "idle_by_span": idle, "learned_calls": calls}


def _learned_ops(record: dict):
    """The operations under the learned graph's range, or None where a call
    lacks a stage range."""
    calls = record["learned_calls"]
    if not calls or any(sorted(c) != sorted(STAGES) for c in calls):
        return None
    return [o for o in record["ops"] if LEARNED in o["path"]]


def learned_stage_ms(record: dict) -> dict:
    """Device ms a frame under each learned stage (the convs apart)."""
    ops = _learned_ops(record) or []
    out: dict[str, float] = {}
    for o in ops:
        stage = next((p[len(LEARNED) + 1:] for p in o["path"] if p.startswith(LEARNED + ".")), "other")
        key = f"{stage}.conv" if CONV in o["name"] else stage
        out[key] = out.get(key, 0.0) + o["dur"] / 1e3 / record["frames_in"]
    return out


# ---- the spans of step 3 and of set-up --------------------------------------------------------

def _ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def _puts(program: dict):
    """The top-level puts of step 3 and every span by its parent's id; None
    where the tracer dropped records or no put was spanned."""
    if program.get("dropped", 1) or not program.get("spans"):
        return None
    kids: dict = {}
    for s in program["spans"]:
        kids.setdefault(s["parent"], []).append(s)
    puts = [s for s in kids.get(None, []) if s["name"] == "nu.runtime.put"]
    return (puts, kids) if puts else None


def _under(kids: dict, s: dict, name: str) -> list:
    return [k for k in kids.get(s["id"], []) if k["name"] == name]


def _per_put_ms(program: dict, name: str):
    """Host ms a put of the spans named `name` (fetch parts under the fetch)."""
    found = _puts(program)
    if found is None:
        return None
    puts, kids = found
    total, seen = 0.0, False
    for p in puts:
        for f in _under(kids, p, FETCH) if name.startswith(FETCH + ".") else [p]:
            for s in _under(kids, f, name):
                total, seen = total + _ms(s), True
    return total / len(puts) if seen else None


def _copies_ms(program: dict):
    found = _puts(program)
    if found is None:
        return None
    puts, kids = found
    out = [sum(_ms(c) for c in _under(kids, f, FETCH + ".copy"))
           for p in puts for f in _under(kids, p, FETCH)]
    return sorted(out) or None


def _nearest_rank(values: list, q: float) -> float:
    return float(values[max(0, math.ceil(q * len(values)) - 1)])


def _launch_host_ms(program: dict):
    found = _puts(program)
    if found is None:
        return None
    puts, kids = found
    rest = [_ms(p) - sum(_ms(k) for k in kids.get(p["id"], []) if k["name"] in ("nu.runtime.upload", FETCH))
            for p in puts]
    return statistics.fmean(rest)


def _setup_s(program: dict, name: str):
    spans = program.get("setup")
    if program.get("setup_dropped", 1) or not spans:
        return None
    ids = {s["id"]: s for s in spans}
    outer = [s for s in spans if s["name"] == name
             and not (s["parent"] in ids and ids[s["parent"]]["name"] == name)]
    return sum(s["end_ns"] - s["start_ns"] for s in outer) / 1e9 if outer else None


def _record(program: dict):
    r = program.get("record")
    return r if r is not None and r["window_us"] > 0 and not program.get("dropped", 1) else None


def _glue_ms(program: dict):
    r = _record(program)
    ops = None if r is None else _learned_ops(r)
    if not ops:
        return None
    return sum(o["dur"] for o in ops if CONV not in o["name"]) / 1e3 / r["frames_in"]


def _glue_launches(program: dict):
    r = _record(program)
    ops = None if r is None else _learned_ops(r)
    if not ops:
        return None
    return sum(o["cat"] == "kernel" and CONV not in o["name"] for o in ops) / r["frames_in"]


def _idle_pct(program: dict, fetch: bool):
    r = _record(program)
    if r is None or not any(label.startswith("nu.") for label in r["idle_by_span"]):
        return None
    us = sum(v for k, v in r["idle_by_span"].items()
             if (k.startswith(FETCH) if fetch else k == OUTSIDE))
    return 100.0 * us / r["window_us"]


def _copy_p50(program: dict):
    c = _copies_ms(program)
    return None if c is None else float(statistics.median(c))


def _copy_p99(program: dict):
    c = _copies_ms(program)
    return None if c is None else _nearest_rank(c, 0.99)


# metric -> read(program), None where it finds nothing to read
READERS = {
    "runtime.upload_host_ms": lambda p: _per_put_ms(p, "nu.runtime.upload"),
    "runtime.launch_host_ms": _launch_host_ms,
    "runtime.fetch_wait_own_ms": lambda p: _per_put_ms(p, FETCH + ".wait_own"),
    "runtime.fetch_wait_behind_ms": lambda p: _per_put_ms(p, FETCH + ".wait_behind"),
    "runtime.fetch_copy_ms": _copy_p50,
    "runtime.fetch_copy_p99_ms": _copy_p99,
    "models.glue_ms": _glue_ms,
    "models.glue_launches": _glue_launches,
    "device.idle_fetch_pct": lambda p: _idle_pct(p, True),
    "device.idle_outside_pct": lambda p: _idle_pct(p, False),
    "setup.kernels_s": lambda p: _setup_s(p, "nu.setup.kernels"),
    "setup.weights_s": lambda p: _setup_s(p, "nu.setup.weights"),
}


def readings(program: dict) -> dict:
    return {name: v for name, read in READERS.items() if (v := read(program)) is not None}


def host_self_ms(program: dict) -> dict:
    """Host ms a put of each span's self time (its length less its
    children's), by name, the largest first; empty where `_puts` finds
    nothing."""
    found = _puts(program)
    if found is None:
        return {}
    puts, kids = found
    out: dict[str, float] = {}
    for s in program["spans"]:
        own = _ms(s) - sum(_ms(k) for k in kids.get(s["id"], []))
        out[s["name"]] = out.get(s["name"], 0.0) + own / len(puts)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def breakdown(record: dict, program: dict) -> dict:
    """The card's idle seconds by the host's innermost ``nu.`` range (the
    largest first), the learned graph's device ms a frame by stage and its
    calls in the window ([all, with every stage range]), and the host's self
    time a put by span."""
    idle = sorted(record["idle_by_span"].items(), key=lambda kv: -kv[1])[:TOP]
    calls = record["learned_calls"]
    return {"idle_by_span": [[k, v * 1e-6] for k, v in idle], "learned_stage_ms": learned_stage_ms(record),
            "learned_calls": [len(calls), sum(sorted(c) == sorted(STAGES) for c in calls)],
            "host_self_ms": host_self_ms(program)}


# ---- the run ---------------------------------------------------------------------------------

def _window(loop, steps: int, device, scratch: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            for _ in range(steps):
                loop.step(False)
            run._sync(device)
    path = scratch / "program_trace.json"
    prof.export_chrome_trace(str(path))
    try:
        return reduce_program(trace.load_events(path), steps)
    finally:
        path.unlink(missing_ok=True)


def measure(cell: dict, seed: int, seconds: float, device, t_start: float,
            cfg: dict | None = None, mix: dict | None = None) -> dict:
    """Steps 1 and 2 of the module's docstring for `cell`; the tracer must have
    been enabled at `t_start` for the set-up spans. `cfg` / `mix` replace
    the files' (tests shrink the sizes)."""
    from nu_scaler_tpu_torch.utils import tracing

    from portbench import frames
    from portbench.window import ClosedLoop

    cfg = cfg if cfg is not None else registry.config(cell["config"])
    mix = mix if mix is not None else registry.traffic(cell["traffic"])
    system, link = registry.system(cfg["system"]), registry.link(mix["link"])
    scratch = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        inputs = link.host_inputs(frames.make_clip(mix, cfg["in_h"], cfg["in_w"], seed))
        fns = system.build(cfg, device, scratch)
        fns.update(link.program(cfg, device))
        names = {**system.SPANS, **link.SPANS}
        fns = {k: run.Spanned(f, names[k]) if k in names else f for k, f in fns.items()}
        depth = int(mix["depth"])
        pipe = run.build_pipeline(fns, device, depth)
        loop = ClosedLoop(pipe.put, pipe.drain, lambda i: inputs[i % len(inputs)], depth,
                          lambda i: system.payloads_per_frame(cfg, i), lambda p: link.well_formed(p, cfg))
        loop.warm(int(mix["warmup_steps"]))
        run._sync(device)
        setup_s = time.perf_counter() - t_start
        tracing.disable()
        setup = tracing.drain()

        tracing.enable()  # 1. tracing on, under the profiler
        record = _window(loop, int(mix["traced_steps"]), device, scratch)
        tracing.disable()
        in_window = tracing.drain()
        rates: dict = {"off": [], "on": []}
        spans: list = []
        dropped = in_window["dropped"]
        for _ in range(ROUNDS):  # 2. and 3. in turns
            for side in ("off", "on"):
                if side == "on":
                    tracing.enable()
                w = loop.open()
                loop.run(seconds / ROUNDS)
                rates[side].append(w)
                if side == "on":
                    tracing.disable()
                    got = tracing.drain()
                    spans += got["spans"]
                    dropped += got["dropped"]
        loop.close()
        run._sync(device)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    program = {"record": record, "spans": spans, "dropped": dropped, "setup": setup["spans"],
               "setup_dropped": setup["dropped"]}
    loads = [s["library"] for s in in_window["spans"] + spans if s["name"] == "nu.setup.kernels"]
    cost = {side: {"output_fps": [w.output_fps() for w in ws],
                   "put_ms_p50": [statistics.median(w.put_s) * 1e3 for w in ws if w.put_s]}
            for side, ws in rates.items()}
    return {"workload": cell["name"], "seed": seed, "setup_s": setup_s, "readings": readings(program),
            "program_breakdown": breakdown(record, program), "tracer_cost": cost,
            "kernel_loads_in_window": loads, "dropped": program["dropped"],
            "device": {"kind": run._kind(device), "busy_s": record["busy_us"] * 1e-6,
                       "window_s": record["window_us"] * 1e-6}}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    from nu_scaler_tpu_torch.utils import tracing

    tracing.enable()  # set-up's spans, from the process's start
    args = run.parse(argv)
    run.set_cache_dirs()
    cell = registry.cell(registry.benchmark(), args.workload)

    import torch

    if not torch.cuda.is_available():
        print(f"portbench.program_trace: {args.workload} needs a CUDA device", file=sys.stderr)
        return 3
    result = measure(cell, args.seed, args.seconds, torch.device("cuda", 0), t_start)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
