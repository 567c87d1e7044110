"""Device selection for the port.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``, or sets the process-wide default with
`set_default_device` (the launcher's ``--device`` flag does, for an app that
passes no device). Asking for CUDA on a machine without a card raises; there
is no silent fallback to the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

# The device of every call that names none; None: the card. Set only by
# `set_default_device`.
_default: Optional[torch.device] = None


def set_default_device(device) -> Optional[torch.device]:
    """Make `device` ("cuda" or "cpu") the device of every entry point called
    without one, for the whole process; ``None`` restores the card. Returns
    the default it replaces."""
    global _default
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    previous, _default = _default, dev
    return previous


def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "nu_scaler_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return torch.device("cuda", torch.cuda.current_device())


def default_device() -> torch.device:
    """The device `set_default_device` set, else the card; raises when the
    card is asked for and PyTorch sees no CUDA device."""
    return _card() if _default is None else resolve_device(_default)


def resolve_device(device=None) -> torch.device:
    """``None`` → `default_device()`; ``"cpu"`` passes through; a CUDA device
    is checked for availability and given its index, so that devices compare
    equal to a tensor's ``.device``."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type == "cuda":
        current = _card()
        return dev if dev.index is not None else current
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
