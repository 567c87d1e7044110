"""Device detection — the port's counterpart of
`nu_scaler_tpu/runtime/detector.py` (the `GpuDetector` role of the
reference's `gpu/detector.rs:89-262`), over PyTorch's CUDA device queries.

The "adapters" are the CUDA devices PyTorch sees (from
`torch.cuda.get_device_properties`), then the host CPU. The primary device is
the first card, else the CPU. `detect()` is the process's cached detector.
Vendors and technologies are the API's constants (`constants.py`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from nu_scaler_tpu_torch.constants import TECH_FALLBACK, TECH_WGPU, VENDOR_NVIDIA, VENDOR_OTHER, GpuVendor
from nu_scaler_tpu_torch.models import esrgan_lite


@dataclasses.dataclass
class DeviceInfo:
    """Parity with `GpuInfo` (detector.rs:29-47) and the `get_gpu_info()`
    dict keys (lib.rs:667-704)."""

    name: str
    vendor: GpuVendor
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
            "vendor": self.vendor.name.capitalize(),  # the debug format, e.g. "Nvidia"
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
        return (TECH_FALLBACK if primary is None or primary.platform == "cpu" else TECH_WGPU).value

    def detect_technologies(self) -> dict:
        """Availability per technology string, with the JAX package's keys
        (`nu_scaler_tpu/runtime/detector.py:124-152`): "wgpu" (the resample
        kernel) and "fsr" (the FSR kernel) on any device; "dlss" (the learned
        tier) when weights of the "quality" ladder serve, trained ones in
        the trainer's `CKPT_ROOT` or the committed ones
        (`models.esrgan_lite.learned_tier_available`, the sidecar probe); no
        Intel SDK ("xess") and no Vulkan; "fallback" always."""
        return {
            "wgpu": True,
            "fsr": True,
            "dlss": esrgan_lite.learned_tier_available("quality"),
            "xess": False,
            "vulkan": False,
            "fallback": True,
        }


@functools.lru_cache(maxsize=1)
def detect() -> DeviceDetector:
    """The process's detector, its devices detected once."""
    d = DeviceDetector()
    d.detect_gpus()
    return d
