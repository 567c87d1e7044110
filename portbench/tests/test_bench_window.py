"""The window's arithmetic: the rate over the whole window, the p95 over all
frames, and both moving when a stall is put in."""

from __future__ import annotations

import numpy as np

from portbench.window import ClosedLoop, Reservoir, p95


class Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class FakePipeline:
    """A `put` that takes `step_s` of the fake clock (plus `stall_s` on frame
    `stall_at`) and returns the payloads of the frame `depth` puts back, two
    a frame (one for frame 0)."""

    def __init__(self, clock: Clock, depth: int, step_s: float, stall_at=None, stall_s=0.0) -> None:
        self.clock, self.depth, self.step_s = clock, depth, step_s
        self.stall_at, self.stall_s = stall_at, stall_s
        self.inflight: list = []
        self.n = 0

    def put(self, frame) -> list:
        self.clock.t += self.step_s + (self.stall_s if self.n == self.stall_at else 0.0)
        self.inflight.append([frame] * (1 if self.n == 0 else 2))
        self.n += 1
        return self.inflight.pop(0) if len(self.inflight) > self.depth else []

    def drain(self) -> list:
        self.clock.t += self.step_s  # the fetch of what is left takes time
        out = [p for f in self.inflight for p in f]
        self.inflight.clear()
        return out


STEP = 2.0 ** -7  # exact in binary, so the fake clock adds up exactly


def run(step_s=STEP, stall_at=None, stall_s=0.0, seconds=100 * STEP, warm=4):
    clock = Clock()
    pipe = FakePipeline(clock, 2, step_s, stall_at, stall_s)
    loop = ClosedLoop(pipe.put, pipe.drain, lambda i: i, 2, lambda i: 1 if i == 0 else 2,
                      lambda p: isinstance(p, int), Reservoir(3, 5), clock)
    loop.warm(warm)
    w = loop.open()
    loop.run(seconds)
    loop.close()
    return w


def test_p95_nearest_rank():
    assert p95([]) is None
    assert p95(list(range(1, 101))) == 95.0
    assert p95([5.0]) == 5.0
    assert p95(list(range(1, 21))) == 19.0


def test_rate_and_latency_steady():
    w = run()
    assert len(w.started) == 100
    assert w.outputs == 200  # every put in the window returned a frame's two payloads
    assert w.output_fps() == 256.0
    lat = w.latencies_ms()
    assert len(lat) == 98  # the last two frames come back only in the drain
    assert p95(lat) == 3 * STEP * 1e3  # its own put and the two after it
    assert w.attempted(lambda i: 2) == 200 and w.failed(lambda i: 2) == 0


def test_a_stall_moves_rate_and_tail():
    stalled = run(stall_at=50, stall_s=16 * STEP)
    assert len(stalled.started) == 84
    assert stalled.output_fps() == 168 / (100 * STEP) < 256.0
    lat = stalled.latencies_ms()
    # the three frames in flight across the stall wait for it ...
    assert sorted(lat)[-3:] == [19 * STEP * 1e3] * 3
    # ... 3 of 82 is under 5%, so the p95 holds
    assert p95(lat) == 3 * STEP * 1e3
    # in a window where they are over 5% of the frames, the p95 is theirs
    short = run(stall_at=10, stall_s=16 * STEP, seconds=36 * STEP)
    assert len(short.latencies_ms()) == 18
    assert p95(short.latencies_ms()) == 19 * STEP * 1e3


def test_missing_and_malformed_payloads_fail():
    clock = Clock()
    pipe = FakePipeline(clock, 2, STEP)
    loop = ClosedLoop(pipe.put, pipe.drain, lambda i: i if i % 7 else "bad", 2,
                      lambda i: 1 if i == 0 else 2, lambda p: isinstance(p, int), None, clock)
    loop.warm(3)
    w = loop.open()
    loop.run(30 * STEP)
    loop.close()
    bad = sum(1 for i in w.started if i % 7 == 0)
    assert bad and w.failed(lambda i: 2) == 2 * bad
    assert w.failed(lambda i: 3) == 2 * bad + len(w.started)


def test_reservoir_is_seeded_and_uniform():
    def draw(seed, n=1000):
        r = Reservoir(5, seed)
        for i in range(n):
            r.offer(i)
        return sorted(r.slots)

    assert draw(2**31 + 5) == draw(2**31 + 5)
    assert draw(1) != draw(2)
    counts = np.zeros(10)
    for s in range(400):
        for i in draw(s, 10):
            counts[i] += 1
    assert counts.min() > 150 and counts.max() < 250  # 200 expected per index


def test_kept_payloads_are_the_sampled_frames():
    clock = Clock()
    pipe = FakePipeline(clock, 2, STEP)
    sample = Reservoir(4, 9)
    loop = ClosedLoop(pipe.put, pipe.drain, lambda i: i, 2, lambda i: 2, lambda p: True, sample, clock)
    loop.warm(2)
    w = loop.open()
    loop.run(64 * STEP)
    loop.close()
    assert sorted(w.kept) == sorted(sample.slots)
    assert all(w.kept[i] == [i, i] for i in w.kept)


def test_a_put_that_raises_fails_its_frame_and_the_loop_goes_on():
    clock = Clock()
    pipe = FakePipeline(clock, 2, STEP)

    def put(frame):
        if frame == 20:
            clock.t += STEP
            raise RuntimeError("planted")
        return pipe.put(frame)

    loop = ClosedLoop(put, pipe.drain, lambda i: i, 2, lambda i: 2, lambda p: isinstance(p, int), None, clock)
    loop.warm(4)
    w = loop.open()
    loop.run(40 * STEP)
    loop.close()
    assert w.errors == [(20, "RuntimeError('planted')")]
    assert len(w.started) == 40 and w.failed(lambda i: 2) == 2
    assert all(w.got[i] == 2 for i in w.started if i != 20)


def test_latency_skips_the_traced_frames():
    stalled = run(stall_at=10, stall_s=16 * STEP, seconds=36 * STEP)
    # the stall falls among the first frames: leaving them out leaves its tail out
    assert p95(stalled.latencies_ms(skip=8)) == 3 * STEP * 1e3
    assert stalled.latencies_ms(skip=0) == stalled.latencies_ms()


def test_run_counts_its_seconds_from_since():
    clock = Clock()
    pipe = FakePipeline(clock, 2, STEP)
    loop = ClosedLoop(pipe.put, pipe.drain, lambda i: i, 2, lambda i: 1 if i == 0 else 2,
                      lambda p: isinstance(p, int), None, clock)
    w = loop.open()
    clock.t += 50 * STEP  # a trace read between the window's start and the untraced steps
    loop.run(20 * STEP, since=clock())
    assert len(w.started) == 20
