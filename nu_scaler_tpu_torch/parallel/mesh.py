"""Device-mesh parallelism of the port: the serving half of
`nu_scaler_tpu/parallel/mesh.py`.

JAX's mesh functions are single-controller: one call in one process returns
one array. These are too: one process drives every shard, each on its own
device's current stream (its work runs under ``torch.cuda.device(shard)``, so
allocations and streams follow the shard), and the result comes back as one
tensor on the mesh's first device. No serving function needs a collective;
the only traffic between cards is ``Tensor.to(device, non_blocking=True)``:

* **dp** (data parallel): a batch split over the shards, padded to a
  multiple of the mesh size by repeating the last frame and sliced back.
  `upscale_batch_sharded` runs each shard's frames in one batched launch of
  the resample kernel, `fsr_batch_sharded` of the FSR kernel;
  `interpolate_batch_sharded` runs each pair's flow and warp (the soft warp
  kernel, the learned refinement on the conv kernel), `esrgan_batch_sharded`
  the learned tier's serving graph.
* **sp** (spatial parallel): one frame's output rows split over the shards.
  The input, the small side, is replicated; each shard computes its own rows
  and recomputes whatever halo they need, so the bytes are the
  single-device path's. `upscale_frame_spatial`: each shard its rows of the
  vertical weight matrix (JAX's row-sharded ``wv``). `fsr_frame_spatial`:
  the FSR kernel on the shard's input rows and `FSR_HALO` rows either side.
  `interpolate_frame_spatial`, `interpolate_multi_spatial`: the flow and the
  soft warp's candidate front end (a global top-K histogram) solved once, on
  the mesh's first device, for the whole frame, and each shard warping its
  band of rows (the kernel's row window); "flow_soft_ref" refines each band
  and its net's receptive field on the conv kernel. `esrgan_infer_spatial`:
  the module's forward on each band and its receptive field.

Where JAX solves the sp flow sharded (XLA's halo exchanges), the port solves
it once: the flow stage is bound by the host's launch rate, so splitting it
would multiply launches for nothing. The result is the same function.

A mesh is a tuple of devices: the visible cards (`make_mesh`), or shards
that share one card or the CPU, built explicitly as
``Mesh((torch.device("cuda", 0),) * 4)``, the port's counterpart of JAX's
``--xla_force_host_platform_device_count``. The API reads `default_mesh`.

The dp × tp train step (`models/esrgan_lite.py` `make_sharded_train_step`)
is SPMD instead: one process a rank, `torch.distributed` collectives over
the `DeviceMesh` of `make_2d_mesh` (dims "data" and "model"), its
collectives in `parallel/tp.py`. `world` makes this process a rank and
`spawn_world` starts a world of them; the caller names each rank's device
and the backend: "nccl" across cards, "gloo" for ranks that share one card
or the CPU (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import functools
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
from nu_scaler_tpu_torch.kernels.resample_cuda import ResamplePlan, resample_fused
from nu_scaler_tpu_torch.models import esrgan_lite, interp_refine
from nu_scaler_tpu_torch.ops import fsr as _fsr
from nu_scaler_tpu_torch.ops import interpolate as _interp
from nu_scaler_tpu_torch.ops import resample as _resample

MODES = ("blend", "flow", "flow_soft", "flow_soft_ref")
# Input rows either side of a shard's own that fsr.cu needs at an integer
# scale s: RCAS at the band's edge rows reads one output row beyond them,
# whose EASU reads input rows −1 .. +2 around its own (the band's last input
# row + 3 when s divides its end).
FSR_HALO = 3


class Mesh:
    """A 1-D mesh: the shards' devices in order (one device may hold several
    shards) and the axis name."""

    def __init__(self, devices: Iterable, axis: str = "batch") -> None:
        self.devices = tuple(resolve_device(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    def __len__(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (self.devices, self.axis) == (other.devices, other.axis)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis))

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)}; axis {self.axis!r})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch", device=None) -> Mesh:
    """Every visible card, cuda:0 … cuda:{count − 1}, or the first
    `n_devices` of them; the CPU (``device="cpu"``) is one device. Asking for
    more devices than exist raises ValueError (JAX's ``devs[:n]`` gives
    fewer). A mesh of shards that share a device is built explicitly:
    ``Mesh((device,) * n)``."""
    dev = resolve_device(device)
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] if dev.type == "cuda" else [dev]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(f"{n_devices} devices asked for; {len(devs)} {dev.type} device(s) exist")
        devs = devs[:n_devices]
    return Mesh(devs, axis)


def default_mesh(device=None) -> Mesh:
    """The API's mesh: every card when `device` is CUDA and more than one
    card is visible, else the one-shard mesh of `device`."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return make_mesh(device=dev)
    return Mesh((dev,))


def _on(device: torch.device):
    """The shard's device as the current one, for its allocations and stream."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _tensor(x) -> torch.Tensor:
    """A u8 batch or frame as a tensor where it lies (numpy: the host)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, copy=True, order="C")  # torch wants writable memory
    return torch.from_numpy(arr)


def _gather(parts: Sequence[torch.Tensor], mesh: Mesh, dim: int = 0) -> torch.Tensor:
    dev = mesh.devices[0]
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim=dim)


def _pad(x: torch.Tensor, size: int) -> tuple[torch.Tensor, int]:
    """The batch padded to a multiple of `size` by repeating its last frame,
    and its own length."""
    n = x.shape[0]
    pad = (-n) % size
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x, n


def _data_parallel(mesh: Mesh, fn: Callable, *batches: torch.Tensor) -> torch.Tensor:
    """``fn(shard_device, *shard_batches)`` on each shard's equal slice of the
    batches (their length a multiple of the mesh size), gathered."""
    per = batches[0].shape[0] // len(mesh)
    parts = []
    for i, dev in enumerate(mesh.devices):
        with _on(dev):
            parts.append(fn(dev, *(b[i * per : (i + 1) * per].to(dev, non_blocking=True) for b in batches)))
    return _gather(parts, mesh)


def _bands(n: int, size: int, multiple: int = 1) -> list[tuple[int, int]]:
    """`size` bands of consecutive rows 0 .. n − 1, (first row, rows), each a
    multiple of `multiple` rows but the last; equal where they divide, the
    last shorter (or empty) otherwise."""
    step = -(-n // (size * multiple)) * multiple
    return [(min(i * step, n), max(0, min(step, n - i * step))) for i in range(size)]


def _check_divisible(what: str, n: int, size: int) -> None:
    if n % size:
        raise ValueError(f"{what} {n} not divisible by mesh size {size}")


# ---------------------------------------------------------------------------
# dp
# ---------------------------------------------------------------------------


class ShardedBatchResampler:
    """``u8 [N, H, W, 4] → u8 [N, OH, OW, 4]`` with N a multiple of the mesh
    size: each shard's frames in one batched launch of its own resampler
    (`shard_batch_resampler`)."""

    def __init__(self, mesh: Mesh, in_h: int, in_w: int, out_h: int, out_w: int, algorithm: str) -> None:
        self.mesh = mesh
        self.resamplers = {d: _resample.make_resampler(in_h, in_w, out_h, out_w, algorithm, d)
                           for d in mesh.devices}

    def __call__(self, frames) -> torch.Tensor:
        x = _tensor(frames)
        _check_divisible("batch", x.shape[0], len(self.mesh))
        return _data_parallel(self.mesh, lambda dev, part: self.resamplers[dev](part), x)


@functools.lru_cache(maxsize=64)
def shard_batch_resampler(mesh: Mesh, in_h: int, in_w: int, out_h: int, out_w: int,
                          algorithm: str) -> ShardedBatchResampler:
    """The batched resampler with the batch split over `mesh`; frames
    [N, H, W, 4] must have N divisible by the mesh size."""
    return ShardedBatchResampler(mesh, in_h, in_w, out_h, out_w, algorithm)


def upscale_batch_sharded(frames, out_h: int, out_w: int, algorithm: str,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Upscale u8 [N, H, W, 4] frames data-parallel over the mesh (every card
    by default): the API's `upscale_batch` on several cards. A ragged batch
    pads to a multiple of the mesh size and is sliced back."""
    mesh = make_mesh() if mesh is None else mesh
    x, n = _pad(_tensor(frames), len(mesh))
    return shard_batch_resampler(mesh, x.shape[1], x.shape[2], out_h, out_w, algorithm)(x)[:n]


def fsr_batch_sharded(frames, out_h: int, out_w: int, quality: str = "quality",
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """FSR (EASU + RCAS) of u8 [N, H, W, 4] frames data-parallel over the
    mesh: each shard's frames in one batched launch of the FSR kernel (the
    general path at a non-integer scale). Ragged batches pad and slice back."""
    mesh = make_mesh() if mesh is None else mesh
    x, n = _pad(_tensor(frames), len(mesh))
    in_h, in_w = x.shape[1], x.shape[2]
    return _data_parallel(
        mesh, lambda dev, part: _fsr.make_fsr_upscaler(in_h, in_w, out_h, out_w, quality, dev)(part), x
    )[:n]


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mesh interpolation mode: {mode!r} (one of {MODES})")


def pair_mid(a: torch.Tensor, b: torch.Tensor, time_t: float, mode: str, levels: int,
             refine=None) -> torch.Tensor:
    """One pair's mid as the mesh functions compute it (JAX's
    `mesh.py:177-184`): the cross-fade, or full-resolution flow at `levels`
    then the block warp ("flow") or the overlapped soft warp
    (`ops.interpolate.warp_blend_overlap`), refined by `refine` if given."""
    if mode == "blend":
        return _interp.blend_only(a, b, time_t)
    flow = _interp.compute_flow_fast(a, b, levels=levels)
    if mode == "flow":
        return _interp.warp_blend_fast(a, b, flow, time_t)
    mid = _interp.warp_blend_overlap(a, b, flow, time_t)
    return mid if refine is None else refine(a, b, mid)


def interpolate_batch_sharded(pairs_a, pairs_b, time_t: float = 0.5, mode: str = "flow",
                              mesh: Optional[Mesh] = None, levels: int = 2) -> torch.Tensor:
    """Motion-compensated interpolation over a batch of pairs u8
    [N, H, W, 4] × 2, data-parallel over the mesh: each shard runs
    `pair_mid` on its pairs one after another. Modes "blend", "flow",
    "flow_soft" and "flow_soft_ref" (the soft mid refined by the learned
    net's serving graph on the shard's device; raises where JAX raises).
    Ragged batches pad and slice back."""
    _check_mode(mode)
    mesh = make_mesh() if mesh is None else mesh
    a, n = _pad(_tensor(pairs_a), len(mesh))
    b, _ = _pad(_tensor(pairs_b), len(mesh))
    h, w = int(a.shape[1]), int(a.shape[2])
    if mode == "flow_soft_ref" and not (_interp.refine_serves(h, w) and interp_refine.refine_available()):
        raise ValueError(
            "flow_soft_ref needs a trained interp_ref4 checkpoint, H/W divisible by the net "
            f"stride, and height inside the net's serving band (>= {_interp.REFINE_MIN_ROWS} rows)"
        )

    def shard(dev, pa, pb):
        refine = interp_refine.get_refine_graph(h, w, dev) if mode == "flow_soft_ref" else None
        return torch.stack([pair_mid(pa[j], pb[j], time_t, mode, levels, refine)
                            for j in range(pa.shape[0])])

    return _data_parallel(mesh, shard, a, b)[:n]


def esrgan_batch_sharded(frames, out_h: int, out_w: int, mesh: Optional[Mesh] = None,
                         prefer: str = "quality") -> torch.Tensor:
    """The learned tier over a batch u8 [N, H, W, 4] → [N, OH, OW, 4],
    data-parallel over the mesh: each shard runs the production serving
    graph (`esrgan_lite.make_pretrained_batch_upscaler` on its device: the
    same weights, int8 grid and conv kernel as one card) on its frames.
    Ragged batches pad and slice back."""
    mesh = make_mesh() if mesh is None else mesh
    x, n = _pad(_tensor(frames), len(mesh))
    h, w = int(x.shape[1]), int(x.shape[2])
    return _data_parallel(
        mesh, lambda dev, part: esrgan_lite.make_pretrained_batch_upscaler(
            h, w, out_h, out_w, prefer, dev)(part), x
    )[:n]


# ---------------------------------------------------------------------------
# sp
# ---------------------------------------------------------------------------


class SpatialResampler:
    """``u8 [H, W, 4] → u8 [OH, OW, 4]`` with the output rows split over the
    mesh: shard k launches the resample kernel on the replicated input with
    rows k·OH/D .. (k + 1)·OH/D − 1 of the vertical weight matrix
    (`shard_spatial_resampler`)."""

    def __init__(self, mesh: Mesh, in_h: int, in_w: int, out_h: int, out_w: int, algorithm: str) -> None:
        algorithm = _resample.normalize_algorithm(algorithm)
        _check_divisible("out_h", out_h, len(mesh))
        self.mesh = mesh
        self.in_hw = (in_h, in_w)
        wv = _resample.axis_weights(in_h, out_h, algorithm)
        wh = _resample.axis_weights(in_w, out_w, algorithm)
        rows = out_h // len(mesh)
        self.plans = [ResamplePlan(wv[k * rows : (k + 1) * rows], wh, dev)
                      for k, dev in enumerate(mesh.devices)]

    def __call__(self, frame) -> torch.Tensor:
        x = _tensor(frame)
        if tuple(x.shape) != (*self.in_hw, 4):
            raise ValueError(f"expected [{self.in_hw[0]}, {self.in_hw[1]}, 4], got {tuple(x.shape)}")
        parts = []
        for plan in self.plans:
            with _on(plan.device):
                parts.append(resample_fused(x.to(plan.device, non_blocking=True), plan))
        return _gather(parts, self.mesh)


@functools.lru_cache(maxsize=64)
def shard_spatial_resampler(mesh: Mesh, in_h: int, in_w: int, out_h: int, out_w: int,
                            algorithm: str) -> SpatialResampler:
    """Single-frame resample with its output rows split over the mesh (sp);
    raises ValueError when the mesh size does not divide out_h, as JAX's."""
    return SpatialResampler(mesh, in_h, in_w, out_h, out_w, algorithm)


def upscale_frame_spatial(frame, out_h: int, out_w: int, algorithm: str,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One u8 [H, W, 4] frame resampled with its output rows over the mesh."""
    mesh = make_mesh() if mesh is None else mesh
    h, w = np.shape(frame)[0], np.shape(frame)[1]
    return shard_spatial_resampler(mesh, h, w, out_h, out_w, algorithm)(frame)


def _fsr_band(x: torch.Tensor, fn: _fsr.FsrUpscaler, quality: str, o0: int, rows: int) -> torch.Tensor:
    """Output rows o0 .. o0 + rows − 1 of ``fn(x)``, computed from the rows
    of `x` they need: at an integer scale the FSR kernel on the band's input
    rows and `FSR_HALO` either side; otherwise EASU on those output rows and
    one either side (RCAS's neighbours), then RCAS on them."""
    (in_h, _), (out_h, out_w) = fn.in_hw, fn.out_hw
    if fn.scale is not None:
        s = fn.scale
        r0 = max(0, o0 // s - FSR_HALO)
        r1 = min(in_h, -(-(o0 + rows) // s) + FSR_HALO)
        crop = x[r0:r1]
        up = _fsr.make_fsr_upscaler(r1 - r0, crop.shape[1], (r1 - r0) * s, out_w, quality, fn.device)(crop)
        return up[o0 - r0 * s : o0 - r0 * s + rows]
    e0, e1 = max(0, o0 - 1), min(out_h, o0 + rows + 1)
    band = _fsr.rcas(_fsr.easu(x, out_h, out_w, fn.sharp, e0, e1 - e0), fn.sharp)
    return band[o0 - e0 : o0 - e0 + rows]


def fsr_frame_spatial(frame, out_h: int, out_w: int, quality: str = "quality",
                      mesh: Optional[Mesh] = None, axis: str = "batch") -> torch.Tensor:
    """One frame's FSR (EASU + RCAS) with its output rows split over the mesh
    (sp): u8 [H, W, 4] → u8 [OH, OW, 4], the bytes of the single-device
    upscaler. H must divide by the mesh size, as JAX's input sharding
    requires; output bands of ceil(OH / D) rows, the last shorter."""
    mesh = make_mesh(axis=axis) if mesh is None else mesh
    x = _tensor(frame)
    in_h, in_w = int(x.shape[0]), int(x.shape[1])
    _check_divisible("frame height", in_h, len(mesh))
    parts = []
    for dev, (o0, rows) in zip(mesh.devices, _bands(out_h, len(mesh))):
        if rows:
            with _on(dev):
                fn = _fsr.make_fsr_upscaler(in_h, in_w, out_h, out_w, quality, dev)
                parts.append(_fsr_band(x.to(dev, non_blocking=True), fn, quality, o0, rows))
    return _gather(parts, mesh)


def _to(x, dev: torch.device):
    """A tensor, or tuples (named or not) of tensors and numbers, on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    if not isinstance(x, tuple):
        return x
    items = [_to(v, dev) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


class _SpatialMids:
    """One pair's mids at the times `ts`, rows split over the mesh: the flow
    (full resolution at `levels`) and, where the soft warp kernel serves, its
    front end solved once on the mesh's first device; each shard then warps
    its band of rows (and refines it, for "flow_soft_ref")."""

    def __init__(self, mesh: Mesh, a, b, ts: Sequence[float], mode: str, levels: int) -> None:
        _check_mode(mode)
        self.mesh, self.ts, self.mode = mesh, tuple(float(t) for t in ts), mode
        dev0 = mesh.devices[0]
        a, b = _tensor(a), _tensor(b)
        for x in (a, b):
            if x.dim() != 3 or x.shape[-1] != 4 or x.dtype != torch.uint8:
                raise ValueError(f"expected u8 [H, W, 4] frames, got {x.dtype} {tuple(x.shape)}")
        self.h, self.w = int(a.shape[0]), int(a.shape[1])
        _check_divisible("frame height", self.h, len(mesh))
        self.step = 1
        if mode == "flow_soft_ref":
            model = interp_refine.load_model()[0]
            self.step = model.stride
            self.halo = receptive_rows(model)
            if self.w % self.step or (self.h // len(mesh)) % self.step:
                raise ValueError(f"flow_soft_ref: the frame's rows per shard ({self.h} / {len(mesh)}) "
                                 f"and width {self.w} must divide by the net's stride {self.step}")
        self.a, self.b = a, b
        self.flow = self.fronts = self.packed = None
        self.kernel = False
        if mode != "blend":
            with _on(dev0):
                a0, b0 = a.to(dev0), b.to(dev0)
                self.flow = _interp.compute_flow_fast(a0, b0, levels=levels)
                self.kernel = mode != "flow" and _interp.soft_tiles_fit(self.h, self.w, _interp.WARP_TILE)
                if self.kernel:
                    self.fronts = [_interp.soft_front_end(self.flow, t) for t in self.ts]
                    if dev0.type == "cuda":
                        self.packed = [swc.pack_inputs(f) for f in self.fronts]

    def _mid(self, i: int, dev, a, b, flow, front, packed, row0: int, rows: int) -> torch.Tensor:
        t = self.ts[i]
        if self.mode == "blend":
            return _interp.blend_only(a[row0 : row0 + rows], b[row0 : row0 + rows], t)
        if self.mode == "flow":
            return _interp.warp_blend_fast(a, b, flow, t, row0=row0, rows=rows)
        if self.kernel:
            return swc.soft_warp_rows(a, b, front, _interp.WARP_TILE, _interp.WARP_K, row0, rows, packed)
        return _interp.warp_blend_soft(a, b, flow, t, row0=row0, rows=rows)

    def __call__(self) -> torch.Tensor:
        """u8 [len(ts), H, W, 4] on the mesh's first device."""
        parts = []
        for dev, (r0, rows) in zip(self.mesh.devices, _bands(self.h, len(self.mesh), self.step)):
            with _on(dev):
                a, b = self.a.to(dev, non_blocking=True), self.b.to(dev, non_blocking=True)
                flow = None if self.flow is None or self.kernel else _to(self.flow, dev)
                fronts = [None] * len(self.ts) if self.fronts is None else [_to(f, dev) for f in self.fronts]
                packed = [None] * len(self.ts) if self.packed is None else [_to(p, dev) for p in self.packed]
                if self.mode != "flow_soft_ref":
                    parts.append(torch.stack([self._mid(i, dev, a, b, flow, fronts[i], packed[i], r0, rows)
                                              for i in range(len(self.ts))]))
                    continue
                # the band and the net's receptive field (stride-aligned),
                # refined on the conv kernel; the band's rows kept
                e0, e1 = max(0, r0 - self.halo), min(self.h, r0 + rows + self.halo)
                refine = interp_refine.get_refine_graph(e1 - e0, self.w, dev)
                parts.append(torch.stack([
                    refine(a[e0:e1], b[e0:e1],
                           self._mid(i, dev, a, b, flow, fronts[i], packed[i], e0, e1 - e0))[r0 - e0 : r0 - e0 + rows]
                    for i in range(len(self.ts))
                ]))
        return _gather(parts, self.mesh, dim=1)


def interpolate_frame_spatial(frame_a, frame_b, time_t: float = 0.5, mode: str = "flow",
                              mesh: Optional[Mesh] = None, levels: int = 2,
                              axis: str = "batch") -> torch.Tensor:
    """One pair's interpolation u8 [H, W, 4] × 2 → u8 [H, W, 4] with the
    rows split over the mesh (sp); H must divide by the mesh size. Modes
    "blend", "flow", "flow_soft" and "flow_soft_ref" (the soft mid refined
    by the learned net's serving graph; the rows per shard and the width
    must divide by its stride). The bytes of `pair_mid` on one device."""
    mesh = make_mesh(axis=axis) if mesh is None else mesh
    return _SpatialMids(mesh, frame_a, frame_b, (time_t,), mode, levels)()[0]


def interpolate_multi_spatial(frame_a, frame_b, ts=(1.0 / 3.0, 2.0 / 3.0), mode: str = "flow_soft",
                              mesh: Optional[Mesh] = None, levels: int = 2,
                              axis: str = "batch") -> torch.Tensor:
    """One pair's N-factor frame generation with the rows split over the
    mesh: one motion solve, one mid per entry of `ts` → u8
    [len(ts), H, W, 4]. Modes as in `interpolate_frame_spatial`."""
    mesh = make_mesh(axis=axis) if mesh is None else mesh
    return _SpatialMids(mesh, frame_a, frame_b, ts, mode, levels)()


def receptive_rows(model: torch.nn.Module) -> int:
    """Input rows a learned module's output row depends on either side: one
    s2d row of its stride per 3×3 conv (every conv counted, as if in one
    chain: an upper bound)."""
    return getattr(model, "stride", 1) * sum(isinstance(m, esrgan_lite.Conv3x3) for m in model.modules())


def _replica(model: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    """`model` if its parameters lie on `dev`, else a copy there."""
    p = next(model.parameters())
    return model if p.device == dev else copy.deepcopy(model).to(dev)


def esrgan_infer_spatial(model: torch.nn.Module, x: torch.Tensor, mesh: Optional[Mesh] = None,
                         axis: str = "batch", quant_scales: Optional[dict] = None) -> torch.Tensor:
    """Learned-tier inference with the frame's rows split over the mesh (sp):
    f32 x [N, H, W, 3] in [0, 1] → [N, uH, uW, 3]. Each shard runs the
    module's forward (or, with `quant_scales`, its int8-grid twin
    `esrgan_lite.make_quant_apply`) on its rows and `receptive_rows` either
    side, and keeps its rows. H must divide by the mesh size × the module's
    stride, as JAX's."""
    mesh = make_mesh(axis=axis) if mesh is None else mesh
    st = getattr(model, "stride", 1)
    h = int(x.shape[1])
    _check_divisible("frame height", h, len(mesh) * st)
    halo = receptive_rows(model)
    rows = h // len(mesh)
    parts = []
    for k, dev in enumerate(mesh.devices):
        r0 = k * rows
        e0, e1 = max(0, r0 - halo), min(h, r0 + rows + halo)
        with _on(dev):
            m = _replica(model, dev)
            fn = m if quant_scales is None else esrgan_lite.make_quant_apply(m, quant_scales)
            with torch.no_grad():
                out = fn(x[:, e0:e1].to(dev, non_blocking=True))
            u = out.shape[1] // (e1 - e0)
            parts.append(out[:, (r0 - e0) * u : (r0 - e0 + rows) * u])
    return _gather(parts, mesh, dim=1)


# ---------------------------------------------------------------------------
# the dp × tp train step's world: one process a rank
# ---------------------------------------------------------------------------

BACKENDS = ("nccl", "gloo")
WORLD_TIMEOUT_S = 300.0


@contextlib.contextmanager
def world(rank: int, world_size: int, backend: str, device, store: str,
          timeout: float = WORLD_TIMEOUT_S):
    """This process as rank `rank` of a `torch.distributed` world of
    `world_size` ranks on `backend` ("nccl" or "gloo"), its device `device`
    (made the current CUDA device), the rendezvous the file `store` (a path
    that no earlier world used). A collective that waits longer than
    `timeout` seconds raises. Yields the device; the process group is
    destroyed on the way out."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = resolve_device(torch.device(device))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, backend: str, devices: tuple, tmp: str, args: tuple,
               timeout: float) -> None:
    with world(rank, len(devices), backend, devices[rank], f"{tmp}/store", timeout) as dev:
        result = fn(rank, dev, *args)
    torch.save(result, f"{tmp}/rank{rank}.pt")


def spawn_world(fn: Callable, backend: str, devices: Sequence, args: tuple = (),
                timeout: float = WORLD_TIMEOUT_S) -> list:
    """Run ``fn(rank, device, *args)`` as each rank of a world of
    ``len(devices)`` spawned processes, rank r on ``devices[r]`` (`world`),
    and return the ranks' results in rank order. `fn` and `args` must pickle
    (`fn` a module-level function) and the results hold only tensors and
    plain Python values. The rendezvous is a file in a fresh temporary
    directory, so worlds never share a port. A rank that raises or dies ends
    the others and raises here, and so does a world that outlives `timeout`
    seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="nu_scaler_world_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(fn, backend, tuple(str(d) for d in devices), tmp, args,
                                                   timeout),
                                 nprocs=len(devices), join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {len(devices)} ranks outlived {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=True) for r in range(len(devices))]


def make_2d_mesh(data: int, model: int, device) -> DeviceMesh:
    """The port of `make_2d_mesh` (`nu_scaler_tpu/parallel/mesh.py:40`): a
    `DeviceMesh` of dims ("data", "model") and shape (data, model) over the
    initialised world (`world`), whose size must be data × model; `device`
    is this rank's (made the current CUDA device) and gives the mesh its
    device type."""
    size = dist.get_world_size() if dist.is_initialized() else 0
    if data < 1 or model < 1 or size != data * model:
        raise ValueError(f"a {data} x {model} mesh needs a world of {data * model} ranks; it has {size}")
    dev = resolve_device(torch.device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
