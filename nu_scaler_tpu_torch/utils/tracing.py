"""Tracing and timing of the port: the counterpart of
`nu_scaler_tpu/utils/tracing.py`.

The reference exposes GPU timestamp-query durations
(`get_last_gpu_duration_ms`), host timers around hot calls and an FPS EMA
for the UI overlay. Here:

  * `device_timer`: the per-step device time of a chained state → state
    function, from CUDA events on the card, the host's launches hidden;
  * `trace_to`: a `torch.profiler` window that writes a Chrome trace;
  * `fetch_overhead_s`: one device-to-host round trip of one element;
  * `FrameClock`: FPS EMA with the reference's 0.95 / 0.05 smoothing plus
    p50 / p99 windows;
  * `Timer`: a scoped wall timer for host-side stages.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device


@contextlib.contextmanager
def trace_to(logdir: str, device=None):
    """`torch.profiler` window over the body, written as a Chrome trace to
    ``logdir/trace.json``; the card's activity is traced unless `device` is
    "cpu". Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def fetch_overhead_s(reps: int = 10, device=None) -> float:
    """Seconds of one device-to-host round trip of one element on `device`
    (the card unless "cpu"), the mean of `reps` after a warm-up."""
    t = torch.ones(1, device=resolve_device(device))
    t.item()
    t0 = time.perf_counter()
    for _ in range(reps):
        t.item()
    return (time.perf_counter() - t0) / reps


def _tensors(state) -> list:
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _tensors(s)]
    return []


def _sleep_cycles_per_s() -> float:
    """Clock cycles a second of `torch.cuda._sleep` on the current card,
    timed with CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000)  # warm
    start.record()
    torch.cuda._sleep(2_000_000)
    end.record()
    end.synchronize()
    return 2_000_000 / (start.elapsed_time(end) / 1e3)


_WARMUP_STEPS = 2


def device_timer(body: Callable, state0, iters: int = 20) -> float:
    """Seconds per step of `body`, a shape-preserving state → state function
    (a tensor or a tuple of them), chained over `iters` steps after
    `_WARMUP_STEPS` so that each step consumes the last one's output: the
    median of the steps' times.

    With the state on the card each step is timed by a pair of CUDA events
    on the device's clock, and before each step a sleep kernel holds the
    stream for twice the host's measured enqueue time of a step: the host
    launches the whole step while the device waits, so the events see the
    device's work and not the host's launch rate. (The JAX function runs
    the chain inside one compiled loop, which has no launches, and takes
    the slope between two trip counts to cancel a constant fetch cost
    through its device tunnel; a CUDA event pair sees no such cost, so that
    method is not carried over.) A step of more launches than the device's
    queue holds still waits on the host past the queue's depth. With the
    state on the CPU each step is timed by the host clock."""
    leaves = _tensors(state0)
    if not leaves:
        raise ValueError("device_timer needs a state holding at least one tensor")
    on_card = any(t.is_cuda for t in leaves)
    state = state0
    for _ in range(_WARMUP_STEPS):
        state = body(state)
    if not on_card:
        times = []
        for _ in range(max(int(iters), 1)):
            t0 = time.perf_counter()
            state = body(state)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = body(state)  # the host's enqueue time of one step
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold = int(2.0 * enqueue_s * _sleep_cycles_per_s()) + 1
    steps = []
    for _ in range(max(int(iters), 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        start.record()
        state = body(state)
        end.record()
        steps.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) / 1e3 for s, e in steps]))


class FrameClock:
    """FPS EMA (0.95/0.05) + windowed percentiles for overlay stats."""

    def __init__(self, window: int = 240):
        self.ema_fps = 0.0
        self.frames = 0
        self._last: Optional[float] = None
        self._durations = deque(maxlen=window)

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._durations.append(dt)
            inst = 1.0 / dt if dt > 0 else 0.0
            self.ema_fps = 0.95 * self.ema_fps + 0.05 * inst if self.frames > 1 else inst
        self._last = now
        self.frames += 1
        return self.ema_fps

    def percentiles(self) -> dict:
        if not self._durations:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        d = np.asarray(self._durations) * 1000.0
        return {
            "p50_ms": float(np.percentile(d, 50)),
            "p99_ms": float(np.percentile(d, 99)),
        }


class Timer:
    """Scoped wall timer: `with Timer() as t: ...; t.ms`."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self.ms = self.seconds * 1000.0
        return False
