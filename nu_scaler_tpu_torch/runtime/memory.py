"""Device memory accounting — the port's counterpart of
`nu_scaler_tpu/runtime/memory.py` (the `MemoryPool` / `VramStats` role of
the reference's `gpu/memory.rs:86-765`), over PyTorch's CUDA memory queries.

* stats: `torch.cuda.mem_get_info` gives the card's free and total bytes,
  `torch.cuda.max_memory_allocated` what this process's allocator took; they
  feed the reference's pressure thresholds (Low < 50%, Medium < 75%,
  High < 90%, Critical, memory.rs:328-341). On the CPU the total is the
  host's physical memory and nothing counts as used.
* strategy: Aggressive / Balanced / Conservative / Minimal, chosen by frame
  size and surfaced to callers.
* cleanup: return the allocator's cached blocks to the card.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Optional

import torch


class MemoryPressure(enum.Enum):
    """Thresholds from memory.rs:328-341."""

    LOW = "Low"  # < 50 %
    MEDIUM = "Medium"  # < 75 %
    HIGH = "High"  # < 90 %
    CRITICAL = "Critical"  # >= 90 %

    @staticmethod
    def from_percent(pct: float) -> "MemoryPressure":
        if pct < 50.0:
            return MemoryPressure.LOW
        if pct < 75.0:
            return MemoryPressure.MEDIUM
        if pct < 90.0:
            return MemoryPressure.HIGH
        return MemoryPressure.CRITICAL


class AllocationStrategy(enum.Enum):
    """memory.rs:96-117."""

    AGGRESSIVE = "aggressive"
    BALANCED = "balanced"
    CONSERVATIVE = "conservative"
    MINIMAL = "minimal"

    @staticmethod
    def parse(s: str) -> "AllocationStrategy":
        try:
            return AllocationStrategy((s or "").lower())
        except ValueError:
            return AllocationStrategy.BALANCED  # silent default, lib.rs:553-559

    @staticmethod
    def for_frame(width: int, height: int) -> "AllocationStrategy":
        """By frame size (lib.rs:437-456): above 4× 1080p Conservative, above
        1080p Balanced, else Aggressive."""
        pixels = width * height
        if pixels > 4 * 1920 * 1080:
            return AllocationStrategy.CONSERVATIVE
        if pixels > 1920 * 1080:
            return AllocationStrategy.BALANCED
        return AllocationStrategy.AGGRESSIVE


@dataclasses.dataclass
class VramStats:
    """Field parity with `VramStats` / `PyVramStats` (memory.rs:732-765)."""

    total_mb: float = 0.0
    used_mb: float = 0.0
    free_mb: float = 0.0
    app_allocated_mb: float = 0.0

    @property
    def usage_percent(self) -> float:
        return (self.used_mb / self.total_mb) * 100.0 if self.total_mb > 0 else 0.0


_MB = 1024.0 * 1024.0


def _host_memory_bytes() -> Optional[int]:
    try:
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return None


class MemoryPool:
    """Stats and policy for one device (PyTorch's caching allocator does the
    pooling). Keeps the reference's observable behaviour: stats refreshed at
    most every 5 s unless forced (memory.rs:604-612), pressure levels, the
    strategy knob, and the allocation counters `get_gpu_info()` shows (the
    allocator's live blocks and bytes on the card, 0 on the CPU)."""

    STATS_REFRESH_S = 5.0

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        # accelerators default to Aggressive, hosts to Conservative (memory.rs:112-117)
        self.strategy = (AllocationStrategy.AGGRESSIVE if self.device.type == "cuda"
                         else AllocationStrategy.CONSERVATIVE)
        self._stats = VramStats()
        self._last_update = 0.0
        self.update_vram_usage(force=True)

    # -- stats ------------------------------------------------------------

    def update_vram_usage(self, force: bool = False) -> VramStats:
        now = time.monotonic()
        if not force and (now - self._last_update) < self.STATS_REFRESH_S:
            return self._stats
        self._last_update = now
        if self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            used = total - free
            app = torch.cuda.max_memory_allocated(self.device)
        else:
            total = _host_memory_bytes() or 0
            used = app = 0
        self._stats = VramStats(
            total_mb=total / _MB,
            used_mb=used / _MB,
            free_mb=max(total - used, 0) / _MB,
            app_allocated_mb=app / _MB,
        )
        return self._stats

    def get_vram_stats(self) -> VramStats:
        return self.update_vram_usage()

    def get_current_memory_pressure(self) -> MemoryPressure:
        return MemoryPressure.from_percent(self.get_vram_stats().usage_percent)

    # -- strategy / pool --------------------------------------------------

    def set_allocation_strategy(self, strategy: AllocationStrategy | str) -> None:
        if isinstance(strategy, str):
            strategy = AllocationStrategy.parse(strategy)
        self.strategy = strategy

    def get_allocated_buffers_count(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.memory_stats(self.device).get("allocation.all.current", 0))

    def get_allocated_bytes(self) -> int:
        return torch.cuda.memory_allocated(self.device) if self.device.type == "cuda" else 0

    def force_gpu_usage(self) -> None:
        """`force_gpu_usage` (memory.rs:647-710): a small allocation and
        product on the device, so the first real frame does not pay the
        device's wake-up and the library's first-call costs."""
        x = torch.ones((256, 256), dtype=torch.float32, device=self.device)
        y = x @ x
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        del x, y

    def cleanup_memory(self) -> None:
        """Return the allocator's cached blocks (`cleanup_memory`,
        gpu/mod.rs:117-137)."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.update_vram_usage(force=True)
