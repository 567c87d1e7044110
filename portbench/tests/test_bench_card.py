"""On the card, at each cell's own sizes: the control (the reference in the
precision below the configuration's, in the program's place) fails the
cell's limits on three seeds, and the program passes them. Skips without a
card; run on the H100 with `python3 -m pytest portbench/tests -m card`."""

from __future__ import annotations

import pytest

from portbench import registry
from portbench.control import readings
from portbench.run import set_cache_dirs

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_at_full_size(card, cell):
    set_cache_dirs()
    w = registry.cell(BENCH, cell)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        assert not readings(w, seed, 1.0, card, True, BENCH)["correct"]
    assert readings(w, 2**31 + 104, 1.0, card, False, BENCH)["correct"]
