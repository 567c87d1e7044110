"""The RGBA link: RGBA u8 frames in, RGBA u8 frames out, as the screen-capture
app hands them over and displays them."""

from __future__ import annotations

import numpy as np
import torch

SPANS: dict = {}


def host_inputs(clip: list[np.ndarray]) -> list:
    """What `put` is fed for each clip frame."""
    return list(clip)


def program(cfg: dict, device) -> dict:
    """The pipeline's link functions from the program: none."""
    return {}


def control(device) -> dict:
    return {}


def well_formed(payload, cfg: dict) -> bool:
    return (isinstance(payload, np.ndarray) and payload.dtype == np.uint8
            and payload.shape == (cfg["out_h"], cfg["out_w"], 4))


def planes(payload) -> list[np.ndarray]:
    return [payload]


class Reference:
    def __init__(self, device) -> None:
        self.device = device

    def ingest(self, host_input) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host_input)).to(self.device)

    def deliver(self, rgba: torch.Tensor) -> list[torch.Tensor]:
        return [rgba]
