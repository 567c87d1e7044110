"""The legacy `UpscalingTechnology` registry of the port — the counterpart of
`nu_scaler_core/technologies.py`: the reference crate's technology enum and
its factory's fallback chains (`Nu_scale/src/upscale/mod.rs:24-45` enum,
`mod.rs:92-270` `create_upscaler`), every technology mapped to a tier the
port serves on the card:

| reference technology | here |
|---|---|
| FSR | `PyFsrUpscaler` (the fused FSR kernel) |
| FSR3 | the FSR pipeline at its sharpest preset |
| DLSS | the learned tier, "quality" ladder (`PyAdvancedWgpuUpscaler("ultra")`) |
| XeSS | the learned tier, "performance" ladder |
| NIS | a classical resample (the resample kernel) and RCAS |
| CUDA / Vulkan / GPU | the classical path, through the reference's chains |
| None | `PassThroughUpscaler` |
| Fallback | the basic upscaler with the quality → algorithm map |

The support probes are real: a classical tier is supported when its device
resolves (the card, or "cpu" when asked for); a learned tier when weights of
one of its ladder's archs at ×2 serve (a sidecar `esrgan_{arch}_x2_*.json`
in the trainer's `CKPT_ROOT` or the committed `weights/`,
`esrgan_lite.learned_tier_available`). The chains' order follows the
reference's (an unsupported XeSS → FSR → DLSS → basic, `mod.rs:140-173`; and
so on). Every factory takes `device` (the card unless "cpu").
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nu_scaler_tpu_torch.constants import UpscalingQuality
from nu_scaler_tpu_torch.core.upscaler import (
    PyAdvancedWgpuUpscaler,
    PyFsrUpscaler,
    PyWgpuUpscaler,
)
from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.models import esrgan_lite as _learned
from nu_scaler_tpu_torch.ops import fsr as _fsr
from nu_scaler_tpu_torch.ops import resample as _resample

#: mod.rs:24-45, the reference's names
TECHNOLOGIES = (
    "none",
    "fsr",
    "fsr3",
    "dlss",
    "xess",
    "nis",
    "cuda",
    "vulkan",
    "gpu",
    "fallback",
)


def _quality_to_algorithm(quality: str) -> str:
    """mod.rs:275-282: the basic tier's algorithm for a quality."""
    q = UpscalingQuality.parse(quality).value
    return {"ultra": "lanczos3", "quality": "bicubic", "balanced": "bicubic",
            "performance": "bilinear"}[q]


def _device_available(device=None) -> bool:
    """True when `device` resolves: the card is present, or "cpu" was asked
    for."""
    try:
        resolve_device(device)
    except RuntimeError:
        return False
    return True


def is_supported(technology: str, device=None) -> bool:
    """`Upscaler::is_supported` per technology (mod.rs:66): the classical
    tiers need their device, the learned tiers also their weights."""
    t = (technology or "").lower()
    if t in ("none", "fallback"):
        return True  # common.rs:32-35: runs anywhere
    if t in ("fsr", "fsr3", "nis", "cuda", "vulkan", "gpu", "wgpu"):
        return _device_available(device)
    if t == "dlss":
        return _device_available(device) and _learned.learned_tier_available("quality")
    if t == "xess":
        return _device_available(device) and _learned.learned_tier_available("performance")
    return False


class PassThroughUpscaler(PyWgpuUpscaler):
    """common.rs:8-60: the identity "upscaler" of technology None. Its
    quality is always ultra, and it needs no initialization."""

    def __init__(self, quality: str = "ultra", device=None):
        super().__init__("ultra", "nearest", device)

    def initialize(self, input_width: int, input_height: int,
                   output_width: int, output_height: int) -> None:
        # nothing to build: the output size is the input's (common.rs:17-20)
        self.input_width, self.input_height = input_width, input_height
        self.output_width, self.output_height = input_width, input_height
        self._initialized = True
        self._fn = lambda x: x

    @property
    def name(self) -> str:
        return "Pass-through"

    def needs_initialization(self) -> bool:
        return False

    def upscale(self, data: bytes) -> bytes:
        return bytes(data)  # input.clone() (common.rs:22-25)


class NISUpscaler(PyWgpuUpscaler):
    """The NIS technology (mod.rs:36, an enum arm the reference never
    implemented): NVIDIA Image Scaling is a classical scaler and a
    sharpening pass, so here the quality's resample (`make_resampler`, the
    resample kernel) followed by `ops.fsr.rcas`, FSR's sharpener."""

    def __init__(self, quality: str = "balanced", sharpness: float = 0.2, device=None):
        super().__init__(quality, _quality_to_algorithm(quality), device)
        self.sharpness = float(sharpness)

    def initialize(self, input_width: int, input_height: int,
                   output_width: int, output_height: int) -> None:
        self.input_width, self.input_height = input_width, input_height
        self.output_width, self.output_height = output_width, output_height
        up = _resample.make_resampler(input_height, input_width, output_height, output_width,
                                      self._algorithm, self.device)
        sharp = self.sharpness
        self._fn = lambda x: _fsr.rcas(up(x), sharp)
        self._initialized = True

    @property
    def name(self) -> str:
        return "NISUpscaler"


def create_upscaler(technology: str, quality: str = "balanced",
                    algorithm: Optional[str] = None, device=None):
    """`create_upscaler(technology, quality, algorithm)` (mod.rs:92-270):
    the requested technology through the reference's fallback chains, as an
    upscaler ready to initialize on `device`."""
    t = (technology or "").lower()
    q = UpscalingQuality.parse(quality).value

    def supported(name: str) -> bool:
        return is_supported(name, device)

    def basic():
        # create_basic_upscaler (mod.rs:264-270)
        return PyWgpuUpscaler(q, algorithm or _quality_to_algorithm(q), device)

    def fsr():
        return PyFsrUpscaler(q, device)

    def dlss():
        up = PyAdvancedWgpuUpscaler("ultra", "bilinear", True, device)
        if q in ("performance", "balanced"):
            up.learned_prefer = "performance"
        return up

    def xess():
        up = PyAdvancedWgpuUpscaler("ultra", "bilinear", True, device)
        up.learned_prefer = "performance"
        return up

    if t == "none":
        return PassThroughUpscaler(device=device)
    if t == "fallback":
        return basic()
    if t == "fsr":
        # mod.rs:97-104: FSR → basic
        return fsr() if supported("fsr") else basic()
    if t == "fsr3":
        # mod.rs:105-120: FSR3 → FSR → basic; FSR3 is FSR at its sharpest
        # preset here (its frame generation is the interpolator's)
        if supported("fsr3"):
            return PyFsrUpscaler("ultra" if q in ("ultra", "quality") else q, device)
        return fsr() if supported("fsr") else basic()
    if t == "dlss":
        # mod.rs:121-139: DLSS → FSR → basic
        if supported("dlss"):
            return dlss()
        return fsr() if supported("fsr") else basic()
    if t == "xess":
        # mod.rs:140-173: XeSS → FSR → DLSS → basic
        if supported("xess"):
            return xess()
        if supported("fsr"):
            return fsr()
        return dlss() if supported("dlss") else basic()
    if t == "nis":
        # mod.rs:175-196: NIS → FSR → DLSS → basic
        if supported("nis"):
            return NISUpscaler(q, device=device)
        if supported("fsr"):
            return fsr()
        return dlss() if supported("dlss") else basic()
    if t == "vulkan":
        # mod.rs:217-247: a supported renderer serves the basic upscaler;
        # else FSR → DLSS → basic
        if supported("vulkan"):
            return basic()
        if supported("fsr"):
            return fsr()
        return dlss() if supported("dlss") else basic()
    if t in ("cuda", "gpu"):
        # mod.rs:99-119 (GPU), :197-216 (CUDA), arms the reference left
        # unimplemented: FSR → DLSS → basic
        if supported("fsr"):
            return fsr()
        return dlss() if supported("dlss") else basic()
    raise ValueError(
        f"Unknown upscaling technology: {technology!r} (expected one of {TECHNOLOGIES})"
    )


def upscale_image_file(input_path: str, output_path: str, technology: str = "fallback",
                       quality: str = "quality", scale_factor: float = 2.0,
                       algorithm: Optional[str] = None, device=None) -> tuple[int, int]:
    """mod.rs:285-330 `upscale_image_file`: load an image file, upscale it by
    `scale_factor` with the resolved technology on `device`, save it.
    Returns (out_w, out_h)."""
    from PIL import Image

    img = np.asarray(Image.open(input_path).convert("RGBA"), np.uint8)
    in_h, in_w = img.shape[:2]
    out_w, out_h = int(in_w * scale_factor), int(in_h * scale_factor)
    up = create_upscaler(technology, quality, algorithm, device)
    up.initialize(in_w, in_h, out_w, out_h)
    out = up.upscale(img.tobytes())
    arr = np.frombuffer(out, np.uint8).reshape(up.output_height, up.output_width, 4)
    Image.fromarray(arr, "RGBA").save(output_path)
    return up.output_width, up.output_height
