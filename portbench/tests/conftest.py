"""Fixtures of the benchmark's own tests: tiny cells on the CPU, and the card
for the tests marked `card` (decided inside the fixture, never at import)."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import registry, run

TINY = dict(in_h=64, in_w=128, out_h=128, out_w=256)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python3 -m pytest portbench/tests -m card` on the H100")
    return torch.device("cuda", 0)


def tiny_run(cell_name: str, seed: int = 7, seconds: float = 0.3, trace: bool = False,
             step_fns=None, **mix_overrides) -> dict:
    """One run of a cell on the CPU at 64x128 -> 128x256 (the program's plain
    versions), through the whole harness but the look for a card."""
    bench = registry.benchmark()
    cell = registry.cell(bench, cell_name)
    cfg = {**registry.config(cell["config"]), **TINY}
    mix = {**registry.traffic(cell["traffic"]), "warmup_steps": 4, "traced_steps": 4, **mix_overrides}
    return run.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                        cfg=cfg, mix=mix, step_fns=step_fns, bench=bench)


@pytest.fixture
def tiny():
    return tiny_run
