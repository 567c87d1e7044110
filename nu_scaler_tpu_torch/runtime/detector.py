"""Device detection — the port's counterpart of
`nu_scaler_tpu/runtime/detector.py` (the `GpuDetector` role of the
reference's `gpu/detector.rs:89-262`), over PyTorch's CUDA device queries.

The "adapters" are the CUDA devices PyTorch sees (from
`torch.cuda.get_device_properties`), then the host CPU. The primary device is
the first card, else the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

VENDOR_NVIDIA = "Nvidia"
VENDOR_OTHER = "Other"


@dataclasses.dataclass
class DeviceInfo:
    """Parity with `GpuInfo` (detector.rs:29-47) and the `get_gpu_info()`
    dict keys (lib.rs:667-704)."""

    name: str
    vendor: str
    device_type: str  # "Gpu" | "Cpu" — format!("{:?}") style
    backend: str  # "CUDA" | "CPU"
    vendor_id: int
    device_id: int
    driver_info: str
    is_discrete: bool
    platform: str  # "gpu" | "cpu"
    core_count: int = 1

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "vendor": self.vendor,
            "device_type": self.device_type,
            "backend": self.backend,
            "vendor_id": f"0x{self.vendor_id:X}",
            "device_id": f"0x{self.device_id:X}",
            "driver_info": self.driver_info,
            "is_discrete": self.is_discrete,
        }


def device_info(device: torch.device) -> DeviceInfo:
    """The `DeviceInfo` of one torch device."""
    device = torch.device(device)
    if device.type == "cuda":
        idx = device.index if device.index is not None else torch.cuda.current_device()
        props = torch.cuda.get_device_properties(idx)
        return DeviceInfo(
            name=props.name, vendor=VENDOR_NVIDIA, device_type="Gpu", backend="CUDA",
            vendor_id=0x10DE, device_id=idx,
            driver_info=f"torch {torch.__version__} cuda {torch.version.cuda}",
            is_discrete=True, platform="gpu", core_count=props.multi_processor_count,
        )
    return DeviceInfo(
        name="cpu", vendor=VENDOR_OTHER, device_type="Cpu", backend="CPU", vendor_id=0x0,
        device_id=0, driver_info=f"torch {torch.__version__}", is_discrete=False,
        platform="cpu", core_count=torch.get_num_threads(),
    )


class DeviceDetector:
    """`GpuDetector` parity: detect_gpus / get_primary_gpu /
    get_primary_device / determine_best_upscaling_technology."""

    def __init__(self) -> None:
        self.devices: list[DeviceInfo] = []
        self._torch_devices: list[torch.device] = []

    def detect_gpus(self) -> list[DeviceInfo]:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                 ] if torch.cuda.is_available() else []
        self._torch_devices = [*cards, torch.device("cpu")]
        self.devices = [device_info(d) for d in self._torch_devices]
        return self.devices

    def get_primary_gpu(self) -> Optional[DeviceInfo]:
        """The first card, else the CPU (the reference's discrete-first
        ladder, detector.rs:136-164)."""
        if not self.devices:
            self.detect_gpus()
        return self.devices[0] if self.devices else None

    def get_primary_device(self) -> Optional[torch.device]:
        if not self.devices:
            self.detect_gpus()
        return self._torch_devices[0] if self._torch_devices else None

    def determine_best_upscaling_technology(self) -> str:
        """A card → "wgpu" (the port's CUDA kernels); CPU only → "fallback"."""
        primary = self.get_primary_gpu()
        return "fallback" if primary is None or primary.platform == "cpu" else "wgpu"
