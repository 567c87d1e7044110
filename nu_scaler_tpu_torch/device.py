"""Device selection for the port.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``. Asking for CUDA on a machine without a card raises; there is
no silent fallback to the CPU.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The card; raises when PyTorch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "nu_scaler_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``None`` → the card (see `default_device`); ``"cpu"`` passes through;
    a CUDA device is checked for availability and given its index, so that
    devices compare equal to a tensor's ``.device``."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type == "cuda":
        current = default_device()
        return dev if dev.index is not None else current
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
