"""The 4:2:0 link: (y, u, v) u8 planes in, (y, u, v) planes out, as a
transcode of 4:2:0 video reads and writes them. The program converts on the
card (`ops/color.py`: `make_yuv420_to_rgba` for ingest, `make_delivery_fn`
for the payload); the reference converts with the BT.601 goldens."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import yuv420 as ref

SPANS = {"ingest_fn": "portbench.ops.color.ingest", "deliver_fn": "portbench.ops.color.deliver"}


def host_inputs(clip: list[np.ndarray]) -> list:
    """Each clip frame as its 4:2:0 planes, made once by the frozen numpy
    golden."""
    return [tuple(np.ascontiguousarray(p) for p in ref.rgba_to_yuv420_np(f)) for f in clip]


def program(cfg: dict, device) -> dict:
    from nu_scaler_tpu_torch.ops.color import make_delivery_fn, make_yuv420_to_rgba

    return {"ingest_fn": make_yuv420_to_rgba(cfg["in_h"], cfg["in_w"], device),
            "deliver_fn": make_delivery_fn(cfg["out_h"], cfg["out_w"], "yuv420", 0, device)}


def control(device) -> dict:
    """The link's conversions by the reference in bfloat16."""
    return {"ingest_fn": lambda y, u, v: ref.yuv420_to_rgba(y, u, v, torch.bfloat16),
            "deliver_fn": lambda rgba: ref.rgba_to_yuv420(rgba, torch.bfloat16)}


def well_formed(payload, cfg: dict) -> bool:
    h, w = cfg["out_h"], cfg["out_w"]
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    return (isinstance(payload, tuple) and len(payload) == 3
            and all(isinstance(p, np.ndarray) and p.dtype == np.uint8 and p.shape == s
                    for p, s in zip(payload, shapes)))


def planes(payload) -> list[np.ndarray]:
    return list(payload)


class Reference:
    def __init__(self, device) -> None:
        self.device = device

    def ingest(self, host_input) -> torch.Tensor:
        y, u, v = (torch.from_numpy(p).to(self.device) for p in host_input)
        return ref.yuv420_to_rgba(y, u, v)

    def deliver(self, rgba: torch.Tensor) -> list[torch.Tensor]:
        return list(ref.rgba_to_yuv420(rgba))
