"""Tracing and timing of the port.

Spans: the program marks its layers with `span(name, **attrs)` (``nu.``
names: ``nu.runtime.*`` in `runtime/streaming.py`, ``nu.ops.*``,
``nu.models.*``, ``nu.kernels.*``, ``nu.setup.*``). Tracing is off until
`enable()`; a span site then costs one flag check and returns a shared
no-op context (no clock, no CUDA event, no profiler range). On, each span
records its name, start and end (`time.perf_counter_ns`), its id and its
parent's (a stack per thread), the input frame it belongs to (`frame`, the
index `LivePipeline` gives it, inherited from the parent when not given) and
the bytes it moves (`bytes`: an int, or the tensors and arrays, counted when
the span opens), into a bounded buffer that `drain()` empties. While a
`torch.profiler` session is active, each span also opens a
`record_function` range of its name, so it sits in the device trace on the
profiler's clock and the device work launched under it carries its name.
`drain()` also returns the anchor pair (`perf_counter_ns`, `time_ns`) taken
at `enable()`: a chrome trace's ``ts + baseTimeNanoseconds / 1e3`` is
`time.time_ns()` in microseconds, so an in-memory span can be laid over a
trace.

`device_timer`: the per-step device time of a chained state → state
function, from CUDA events on the card, the host's launches hidden.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable

import numpy as np
import torch

CAPACITY = 1 << 20  # span records kept between drains; beyond, dropped and counted

# Read by every span site (``tracing.on``); set only by enable() / disable().
on = False
_records: list = []
_dropped = 0
_capacity = CAPACITY
_anchor = (0, 0)
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()


class _Off:
    """The span of a site while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


def nbytes(obj) -> int:
    """Bytes of a tensor or an array, of a (nested) tuple or list of them,
    or of anything numpy takes as an array."""
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, (tuple, list)) and all(isinstance(o, (tuple, list)) or hasattr(o, "nbytes")
                                              for o in obj):
        return sum(nbytes(o) for o in obj)
    return int(np.asarray(obj).nbytes)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "frame", "start", "range")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name, self.attrs = name, attrs
        if "bytes" in attrs and not isinstance(attrs["bytes"], int):
            attrs["bytes"] = nbytes(attrs["bytes"])

    def set(self, **attrs) -> None:
        """Attributes known only once the span's work ran."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.frame = self.attrs.pop("frame", up.frame if up is not None else None)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        _keep((self.name, self.start, end, self.id, self.parent, self.frame, self.attrs))
        return False


def _keep(record: tuple) -> None:
    global _dropped
    if len(_records) < _capacity:
        _records.append(record)
    else:
        with _lock:
            _dropped += 1


def span(name: str, **attrs):
    """A context manager timing the work of one layer under `name`; see the
    module's docstring. ``with span(...) as s: ...; s.set(key=value)`` adds
    an attribute after the work (a no-op while tracing is off)."""
    if not on:
        return OFF
    return _Span(name, attrs)


def enable(capacity: int = CAPACITY) -> None:
    """Start recording spans into an empty buffer of `capacity` records, and
    take the clock anchor."""
    global on, _records, _dropped, _capacity, _anchor
    if not torch.autograd._profiler_enabled():  # no range recorded: only its first use's cost paid
        with torch.profiler.record_function("nu.enable"):
            pass  # the range's first use resolves its operator: not inside a span
    _records, _dropped, _capacity = [], 0, int(capacity)
    _anchor = (time.perf_counter_ns(), time.time_ns())
    on = True


def disable() -> None:
    """Stop recording; what was recorded stays until `drain()`."""
    global on
    on = False


def drain() -> dict:
    """The records since `enable()` or the last drain, and how many were
    dropped, the buffer emptied: ``{"spans": [{"name", "start_ns", "end_ns",
    "id", "parent", "frame", "bytes", ...attrs}], "dropped": n, "anchor":
    {"perf_counter_ns", "time_ns"}}``, the spans in the order they ended."""
    global _records, _dropped
    records, dropped = _records, _dropped
    _records, _dropped = [], 0
    spans = [{"name": n, "start_ns": a, "end_ns": b, "id": i, "parent": p, "frame": f,
              "bytes": attrs.get("bytes"), **{k: v for k, v in attrs.items() if k != "bytes"}}
             for n, a, b, i, p, f, attrs in records]
    return {"spans": spans, "dropped": dropped,
            "anchor": {"perf_counter_ns": _anchor[0], "time_ns": _anchor[1]}}


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
