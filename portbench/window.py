"""The measured window: a closed loop over `LivePipeline.put`, and the
arithmetic of its end-to-end numbers.

The loop sends the next input as soon as `put` returns, as a transcode or the
live app running uncapped does. `put` returns the host payloads of the oldest
frame in flight once more than `depth` frames are in flight, so the harness
keeps its own queue of the frames in flight and knows which frame each
payload belongs to.

- Output rate: every payload that reached host memory during the window, over
  the window's seconds (first `put` of the window to the end of the last).
- Frame latency: for every frame whose `put` started in the window and whose
  payloads were all host arrays before it closed, from the start of its
  `put` to the end of the `put` that returned them.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


def p95(values) -> Optional[float]:
    """The 95th percentile by nearest rank: the smallest value that at least
    95% of the values do not exceed. None for no values."""
    if len(values) == 0:
        return None
    s = sorted(values)
    return float(s[max(0, math.ceil(0.95 * len(s)) - 1)])


class Reservoir:
    """A uniform sample of `k` frame indices among those offered, drawn from
    `seed` (algorithm R): the same seed and the same number of offers give
    the same sample."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.slots: list[int] = []
        self.seen = 0

    def offer(self, index: int) -> None:
        if len(self.slots) < self.k:
            self.slots.append(index)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.slots[j] = index
        self.seen += 1

    def __contains__(self, index: int) -> bool:
        return index in self.slots


@dataclass
class Window:
    """What one window saw. Times are host seconds (`time.perf_counter`)."""

    t0: float = 0.0
    t_end: float = 0.0
    outputs: int = 0                     # payloads fetched during the window
    started: list = field(default_factory=list)   # frame indices put in the window
    put_start: dict = field(default_factory=dict)  # frame index -> start of its put
    done: dict = field(default_factory=dict)       # frame index -> when its payloads were host arrays
    got: dict = field(default_factory=dict)        # frame index -> payloads it returned
    bad: dict = field(default_factory=dict)        # frame index -> payloads malformed
    kept: dict = field(default_factory=dict)       # sampled frame index -> its payloads
    put_s: list = field(default_factory=list)      # each put's seconds, in order
    errors: list = field(default_factory=list)     # (frame index, what a put raised)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0

    def output_fps(self) -> float:
        return self.outputs / self.seconds

    def latencies_ms(self, skip: int = 0) -> list[float]:
        """Frame latencies; `skip` leaves out the window's first frames (those
        put under the profiler in a traced run)."""
        return [(self.done[i] - self.put_start[i]) * 1e3 for i in self.started[skip:]
                if i in self.done and self.done[i] <= self.t_end]

    def attempted(self, per_frame: Callable[[int], int]) -> int:
        """Payloads asked of the pipeline by the frames put in the window."""
        return sum(per_frame(i) for i in self.started)

    def failed(self, per_frame: Callable[[int], int]) -> int:
        """Payloads of the window's frames that never came, came malformed, or
        came beyond what the frame asked for."""
        return sum(abs(per_frame(i) - self.got.get(i, 0)) + self.bad.get(i, 0)
                   for i in self.started)


class ClosedLoop:
    """Drives a pipeline's `put` / `drain` with frames by index and records
    each frame's payloads. `frame(i)` gives input i; `per_frame(i)` how many
    payloads input i asks for; `well_formed(payload)` checks one payload's
    shape and type; `sample` decides which frames' payloads are kept for the
    comparison."""

    def __init__(self, put, drain, frame, depth: int, per_frame, well_formed,
                 sample: Optional[Reservoir] = None, clock=time.perf_counter) -> None:
        self.put, self.drain, self.frame = put, drain, frame
        self.depth, self.per_frame, self.well_formed = depth, per_frame, well_formed
        self.sample, self.clock = sample, clock
        self.inflight: deque = deque()
        self.next_index = 0
        self.w: Optional[Window] = None

    def _record(self, index: int, payloads: list, when: float) -> None:
        w = self.w
        if w is None:
            return
        w.got[index] = len(payloads)
        bad = sum(not self.well_formed(p) for p in payloads)
        if bad:
            w.bad[index] = bad
        w.done[index] = when
        if self.sample is not None and index in self.sample:
            w.kept[index] = payloads
        for i in [i for i in w.kept if self.sample is not None and i not in self.sample]:
            del w.kept[i]

    def step(self, in_window: bool) -> int:
        """One `put` of the next frame; returns how many payloads came back."""
        i = self.next_index
        self.next_index += 1
        s = self.clock()
        if in_window:
            self.w.started.append(i)
            self.w.put_start[i] = s
            if self.sample is not None:
                self.sample.offer(i)
        try:
            payloads = self.put(self.frame(i))
        except Exception as ex:  # noqa: BLE001 - a frame that raised is a failed frame, not the run's end
            if not in_window:
                raise
            e = self.clock()
            self.w.errors.append((i, repr(ex)))
            self.w.got[i] = 0
            self.w.put_s.append(e - s)
            self.w.t_end = e
            return 0
        e = self.clock()
        self.inflight.append(i)
        if len(self.inflight) > self.depth:
            self._record(self.inflight.popleft(), payloads, e)
        if in_window:
            self.w.outputs += len(payloads)
            self.w.put_s.append(e - s)
            self.w.t_end = e
        return len(payloads)

    def warm(self, steps: int) -> None:
        for _ in range(steps):
            self.step(False)

    def open(self) -> Window:
        self.w = Window(t0=self.clock())
        self.w.t_end = self.w.t0
        return self.w

    def run(self, seconds: float, since: Optional[float] = None) -> Window:
        """Steps until `seconds` have passed since the window opened, or
        since `since`."""
        w = self.w
        t0 = w.t0 if since is None else since
        while self.clock() - t0 < seconds:
            self.step(True)
        return w

    def close(self) -> Window:
        """Fetches what is still in flight (late, not lost): each frame's
        payloads in order, by how many it asked for."""
        rest = self.drain()
        when = self.clock()
        pos = 0
        while self.inflight:
            i = self.inflight.popleft()
            n = self.per_frame(i)
            self._record(i, rest[pos:pos + n], when)
            pos += n
        return self.w
