"""Runs one cell once and prints the result's line.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as `setup_s`, from the process's start): the card, the cell's
configuration, traffic and limits, the input clip from the seed, the
program's step built and every shape it uses warmed up. Then a closed loop
over `LivePipeline.put` for `--seconds`. With `--trace 1` the first steps of
the window run under `torch.profiler`, then `--seconds` more untraced, and
the per-layer metrics are read from that trace and the untraced steps
instead of the end-to-end ones. After the window: what is in
flight is fetched, the memory peak is read, the program is freed, and the
sampled payloads are compared with the reference.

The last lines of standard error give each compared number beside its
limit; the last line of standard output is the result, whose last key
`compared` holds them too.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

from portbench import registry
from portbench.guard import forbidden_loaded

ROOT = registry.ROOT
# build and kernel caches inside the checkout, at fixed paths
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
              "TRITON_CACHE_DIR": "build/portbench/triton",
              "CUDA_CACHE_PATH": "build/portbench/cuda_cache"}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spanned:
    """A function the pipeline calls, run inside a profiler range of the
    benchmark's own."""

    def __init__(self, fn, name: str) -> None:
        self.fn, self.name = fn, name

    def __call__(self, *args, **kwargs):
        import torch

        with torch.profiler.record_function(self.name):
            return self.fn(*args, **kwargs)


def build_pipeline(fns: dict, device, depth: int):
    from nu_scaler_tpu_torch.runtime.streaming import LivePipeline

    return LivePipeline(fns.get("upscale_fn"), device=device, depth=depth,
                        fused_step_fn=fns.get("fused_step_fn"), ingest_fn=fns.get("ingest_fn"),
                        deliver_fn=fns.get("deliver_fn"))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             cfg: dict | None = None, mix: dict | None = None, step_fns=None,
             bench: dict | None = None) -> dict:
    """One run of `cell` on `device`. `cfg` / `mix` replace the files' (tests
    shrink the sizes); `step_fns(cfg, device, scratch)` replaces the
    program's step and link functions (controls and planted faults)."""
    import torch

    from portbench import frames
    from portbench.compare import compare, judge
    from portbench.window import ClosedLoop, Reservoir

    bench = bench if bench is not None else registry.benchmark()
    cfg = cfg if cfg is not None else registry.config(cell["config"])
    mix = mix if mix is not None else registry.traffic(cell["traffic"])
    limits = registry.limits(cell["name"])
    system = registry.system(cfg["system"])
    link = registry.link(mix["link"])
    scratch = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        clip = frames.make_clip(mix, cfg["in_h"], cfg["in_w"], seed)
        inputs = link.host_inputs(clip)
        del clip
        if step_fns is None:
            fns = system.build(cfg, device, scratch)
            fns.update(link.program(cfg, device))
        else:
            fns = step_fns(cfg, device, scratch)
        if trace:
            spans = {**system.SPANS, **link.SPANS}
            fns = {k: Spanned(f, spans[k]) if k in spans else f for k, f in fns.items()}
        depth = int(mix["depth"])
        pipe = build_pipeline(fns, device, depth)
        per_frame = lambda i: system.payloads_per_frame(cfg, i)  # noqa: E731
        loop = ClosedLoop(pipe.put, pipe.drain, lambda i: inputs[i % len(inputs)], depth, per_frame,
                          lambda p: link.well_formed(p, cfg), Reservoir(int(mix["sample_frames"]), seed))
        loop.warm(int(mix["warmup_steps"]))
        _sync(device)
        setup_s = time.perf_counter() - t_start

        w = loop.open()
        record = since = None
        if trace:  # the traced steps, then `seconds` more untraced after the trace is read
            record = _traced_steps(loop, int(mix["traced_steps"]), device, scratch)
            since = time.perf_counter()
        loop.run(seconds, since)
        loop.close()
        _sync(device)
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

        attempted, failed = w.attempted(per_frame), w.failed(per_frame)
        kept = w.kept
        del pipe, loop, fns
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        ref = registry.reference(cfg["reference"]).Reference(cfg, device)
        readings = compare(kept, inputs, ref, link.Reference(device), link, device)
        reference_s = time.perf_counter() - t_ref
        ok, compared = judge(readings, limits)
        ctx = {"window": w, "setup_s": setup_s, "record": record, "cfg": cfg, "kind": _kind(device),
               "traced_steps": int(mix["traced_steps"]) if trace else 0}
        kind = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in registry.metrics_of(bench, kind, cell["name"]):
            read = (registry.per_layer_reader if trace else registry.end_to_end_reader)(m["name"])
            value = read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": _kind(device),
               "count": 1, "memory_peak_bytes": int(memory_peak)}
        if record is not None:
            dev["busy_s"] = record["busy_us"] * 1e-6
            dev["window_s"] = record["window_us"] * 1e-6
        result = {"correct": bool(ok and failed == 0 and attempted > 0), "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": dev}
        if record is not None:
            result["breakdown"] = record["breakdown"]
        result["frames_in_window"] = len(w.started)
        result["errors"] = w.errors[:5]
        result["latency_frames"] = len(w.latencies_ms())
        if len(w.put_s) > 1:  # how each put's host time spreads: what the rate and tail rest on
            q = statistics.quantiles(w.put_s, n=100, method="inclusive")
            result["put_ms"] = {"p25": q[24] * 1e3, "p50": q[49] * 1e3, "p75": q[74] * 1e3,
                                "p90": q[89] * 1e3, "p99": q[98] * 1e3, "max": max(w.put_s) * 1e3}
        result["reference_s"] = reference_s
        result["compared_frames"] = readings["frames"]
        result["compared"] = compared
        return result
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _traced_steps(loop, steps: int, device, scratch: Path) -> dict:
    """`steps` puts of the window under the profiler, inside the
    ``portbench.window`` range (which ends after the card is idle); the
    chrome trace is written to the run's scratch directory, reduced and
    deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    outs = 0
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            for _ in range(steps):
                outs += loop.step(True)
            _sync(device)
    path = scratch / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        return trace.reduce(trace.load_events(path), steps, outs)
    finally:
        path.unlink(missing_ok=True)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs(root: Path = ROOT) -> None:
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(root / rel)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    set_cache_dirs()
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); {n} visible",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      t_start, bench=bench)
    found = forbidden_loaded()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for i, err in result["errors"]:
        print(f"portbench: the put of frame {i} raised {err}", file=sys.stderr)
    print(f"latency frames (put and fetched in the window): {result['latency_frames']}; "
          f"frames put: {result['frames_in_window']}; compared frames: {result['compared_frames']}",
          file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
