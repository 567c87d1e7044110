"""Frame pipelines of the port: the counterpart of
`nu_scaler_tpu/runtime/streaming.py` (FramePipeline, LivePipeline).

PyTorch launches on the card asynchronously, so a frame's upload, its kernels
and the previous frames' downloads overlap as long as the host does not wait
between them; the only waits are the device-to-host fetches of finished
outputs. `depth` frames stay in flight, as in the JAX pipelines.

`LivePipeline` also takes the live link's transfer formats (`ops/color.py`):
an `ingest_fn` that turns a planar 4:2:0 capture frame, fed as a (y, u, v)
tuple, into RGBA on the device, and a `deliver_fn` that turns every output
frame into its host payload on the device (4:2:0 planes and / or a preview
size). The uploads and downloads stay pageable and on the current stream.

`LivePipeline.put` is traced (`utils/tracing`): ``nu.runtime.put`` a frame,
and under it ``nu.runtime.upload``, ``nu.runtime.step``,
``nu.runtime.deliver`` and ``nu.runtime.fetch`` (of the frame `depth` puts
back). With tracing on, the fetch first waits for that frame's own work
(``.wait_own``, a CUDA event recorded at the end of its `put`), then for the
newer frames' work queued ahead of it (``.wait_behind``), then copies on an
idle stream (``.copy``): the pageable ``.cpu()`` waits for both anyway, so
the split adds no wait. With tracing off the fetch is the plain ``.cpu()``.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.ops.resample import to_device_u8
from nu_scaler_tpu_torch.utils import tracing
from nu_scaler_tpu_torch.utils.tracing import span


def _fetch(payload):
    """A device payload on the host: a tensor as a numpy array, a tuple of
    planes as a tuple of arrays."""
    if isinstance(payload, tuple):
        return tuple(p.cpu().numpy() for p in payload)
    return payload.cpu().numpy()


def _fetch_traced(ready: list, frame: int, done, device: torch.device) -> list:
    """`_fetch` of one frame's payloads, its waits split out (tracing on)."""
    with span("nu.runtime.fetch", frame=frame, bytes=ready):
        with span("nu.runtime.fetch.wait_own"):
            if done is not None:
                done.synchronize()
        with span("nu.runtime.fetch.wait_behind"):
            if device.type == "cuda":
                behind = torch.cuda.Event()
                behind.record(torch.cuda.current_stream(device))
                behind.synchronize()
        with span("nu.runtime.fetch.copy"):
            return [_fetch(o) for o in ready]


class FramePipeline:
    """Software-pipelined frame processor.

    fn: device function (u8 tensor in → u8 tensor out)
    depth: number of frames in flight (2 = double buffering, 3 = triple)
    """

    def __init__(self, fn: Callable, device=None, depth: int = 2) -> None:
        self.fn = fn
        self.device = resolve_device(device)
        self.depth = max(1, depth)
        self._inflight: list[torch.Tensor] = []

    def put(self, frame) -> Optional[torch.Tensor]:
        """Feed one frame; returns a completed (device) output once the
        pipeline is full, else None (still filling)."""
        self._inflight.append(self.fn(to_device_u8(frame, self.device)))
        if len(self._inflight) > self.depth:
            return self._inflight.pop(0)
        return None

    def drain(self) -> Iterator[torch.Tensor]:
        while self._inflight:
            yield self._inflight.pop(0)

    def process_stream(self, frames: Iterable) -> Iterator[np.ndarray]:
        for f in frames:
            out = self.put(f)
            if out is not None:
                yield _fetch(out)
        for out in self.drain():
            yield _fetch(out)


class LivePipeline:
    """The live tick: capture → [interpolate prev/cur] → upscale.

    Per input frame the pipeline emits 1 output frame for the first frame or
    without interpolation, else the mid frame(s) and then the current frame.

    fused_step_fn: ``fn(cur, prev_up) → (cur_up, *mids)`` and
    ``fn(cur, None) → (cur_up,)`` with ``fn.out_hw`` — the fused resample +
    cross-fade kernel (`ops.resample.make_fused_blend`), one launch per step.
    amortize_blend: with `interp_fn`, blend the already-upscaled frames and
    reuse the previous step's upscale.
    ingest_fn: ``fn(y, u, v) → RGBA`` on the device, applied when `put` /
    `put_device` get a (y, u, v) tuple; each plane is uploaded on its own,
    then converted on the device (`ops.color.make_yuv420_to_rgba`).
    deliver_fn: applied on the device to every output frame before it is
    queued (`ops.color.make_delivery_fn`); its payloads may be tuples of
    planes, which `put` / `drain` fetch as tuples of arrays.
    """

    def __init__(
        self,
        upscale_fn: Callable,
        interp_fn: Optional[Callable] = None,
        device=None,
        depth: int = 2,
        amortize_blend: bool = False,
        fused_step_fn: Optional[Callable] = None,
        ingest_fn: Optional[Callable] = None,
        deliver_fn: Optional[Callable] = None,
    ) -> None:
        self.upscale_fn = upscale_fn
        self.interp_fn = interp_fn
        self.device = resolve_device(device)
        self.depth = max(1, depth)
        self.amortize_blend = amortize_blend
        self.fused_step_fn = fused_step_fn
        self.ingest_fn = ingest_fn
        self.deliver_fn = deliver_fn
        self._prev: Optional[torch.Tensor] = None
        self._prev_up: Optional[torch.Tensor] = None
        self._inflight: list[tuple] = []  # (frame index, device payloads, CUDA event or None)
        self.frames_in = 0
        self.frames_out = 0

    def put(self, frame) -> list:
        """Feed one captured frame (RGBA, or a (y, u, v) tuple under an
        `ingest_fn`); returns 0+ completed host-side payloads."""
        with span("nu.runtime.put", frame=self.frames_in):
            ready, index, done = self._enqueue(frame)
            if not tracing.on or not ready:
                return [_fetch(o) for o in ready]
            return _fetch_traced(ready, index, done, self.device)

    def put_device(self, frame) -> list:
        """Like put(), but returns device payloads without a host sync."""
        with span("nu.runtime.put", frame=self.frames_in):
            return self._enqueue(frame)[0]

    def _enqueue(self, frame) -> tuple:
        """Launch one frame's work; returns the device payloads of the frame
        `depth` puts back once that many are in flight, that frame's index
        and the CUDA event recorded after its launches (tracing on, on the
        card; else None)."""
        planar = self.ingest_fn is not None and isinstance(frame, tuple)
        with span("nu.runtime.upload", bytes=frame):
            if planar:
                cur = [to_device_u8(p, self.device) for p in frame]
            else:
                cur = to_device_u8(frame, self.device)
        if planar:
            cur = self.ingest_fn(*cur)
        outs: list = []
        with span("nu.runtime.step"):
            if self.fused_step_fn is not None:
                if self._prev_up is None:
                    # pipeline fill: the first frame's upscale alone
                    (self._prev_up,) = self.fused_step_fn(cur, None)
                    outs.append(self._prev_up)
                else:
                    cur_up, *mids = self.fused_step_fn(cur, self._prev_up)
                    outs.extend(mids)
                    outs.append(cur_up)
                    self._prev_up = cur_up
            elif self.amortize_blend and self.interp_fn is not None:
                cur_up = self.upscale_fn(cur)
                if self._prev_up is not None:
                    outs.append(self.interp_fn(self._prev_up, cur_up, 0.5))
                outs.append(cur_up)
                self._prev_up = cur_up
            else:
                if self.interp_fn is not None and self._prev is not None:
                    outs.append(self.upscale_fn(self.interp_fn(self._prev, cur, 0.5)))
                outs.append(self.upscale_fn(cur))
        self._prev = cur
        if self.deliver_fn is not None:
            with span("nu.runtime.deliver"):
                outs = [self.deliver_fn(o) for o in outs]
        done = None
        if tracing.on and self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        self._inflight.append((self.frames_in, tuple(outs), done))
        self.frames_in += 1
        if len(self._inflight) <= self.depth:
            return [], None, None
        index, ready, done = self._inflight.pop(0)
        self.frames_out += len(ready)
        return list(ready), index, done

    def drain(self) -> list:
        return [_fetch(o) for o in self.drain_device()]

    def drain_device(self) -> list:
        ready = []
        while self._inflight:
            ready.extend(self._inflight.pop(0)[1])
        self.frames_out += len(ready)
        return ready


def benchmark_live_pipeline(
    upscale_fn: Callable,
    interp_fn: Optional[Callable],
    frames: list,
    warmup: int = 4,
    depth: int = 2,
    device=None,
) -> dict:
    """Throughput and latency of the live pipeline over a frame sequence
    (host frames in, every output fetched to the host), on `device` (the
    card unless "cpu"): output frames per second and per-input-step latency
    percentiles, with the JAX function's keys."""
    pipe = LivePipeline(upscale_fn, interp_fn, device=device, depth=depth)
    for f in frames[:warmup]:
        pipe.put(f)
    pipe.drain()

    pipe.frames_out = 0
    step_times = []
    t0 = time.perf_counter()
    for f in frames[warmup:]:
        s0 = time.perf_counter()
        pipe.put(f)
        step_times.append((time.perf_counter() - s0) * 1000.0)
    pipe.drain()
    total = time.perf_counter() - t0
    n_out = pipe.frames_out
    return {
        "output_frames": n_out,
        "seconds": total,
        "fps": n_out / total if total > 0 else float("inf"),
        "p50_step_ms": float(np.percentile(step_times, 50)) if step_times else 0.0,
        "p99_step_ms": float(np.percentile(step_times, 99)) if step_times else 0.0,
    }
