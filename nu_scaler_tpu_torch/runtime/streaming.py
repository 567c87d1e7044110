"""Frame pipelines of the port: the counterpart of
`nu_scaler_tpu/runtime/streaming.py` (FramePipeline, LivePipeline).

PyTorch launches on the card asynchronously, so a frame's upload, its kernels
and the previous frames' downloads overlap as long as the host does not wait
between them; the only waits are the device-to-host fetches of finished
outputs. `depth` frames stay in flight, as in the JAX pipelines.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.ops.resample import to_device_u8


def _fetch(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


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
    """

    def __init__(
        self,
        upscale_fn: Callable,
        interp_fn: Optional[Callable] = None,
        device=None,
        depth: int = 2,
        amortize_blend: bool = False,
        fused_step_fn: Optional[Callable] = None,
    ) -> None:
        self.upscale_fn = upscale_fn
        self.interp_fn = interp_fn
        self.device = resolve_device(device)
        self.depth = max(1, depth)
        self.amortize_blend = amortize_blend
        self.fused_step_fn = fused_step_fn
        self._prev: Optional[torch.Tensor] = None
        self._prev_up: Optional[torch.Tensor] = None
        self._inflight: list[tuple] = []
        self.frames_in = 0
        self.frames_out = 0

    def put(self, frame) -> list:
        """Feed one captured frame; returns 0+ completed host-side frames."""
        return [_fetch(o) for o in self.put_device(frame)]

    def put_device(self, frame) -> list:
        """Like put(), but returns device tensors without a host sync."""
        cur = to_device_u8(frame, self.device)
        outs: list = []
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
        self.frames_in += 1
        self._inflight.append(tuple(outs))
        ready: list = []
        if len(self._inflight) > self.depth:
            ready.extend(self._inflight.pop(0))
            self.frames_out += len(ready)
        return ready

    def drain(self) -> list:
        return [_fetch(o) for o in self.drain_device()]

    def drain_device(self) -> list:
        ready = []
        while self._inflight:
            ready.extend(self._inflight.pop(0))
        self.frames_out += len(ready)
        return ready
