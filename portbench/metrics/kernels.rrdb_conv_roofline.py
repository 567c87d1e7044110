"""kernels: the RRDBNet's convolutions against the card's dense fp16 peak,
in %: a traced frame's real-width conv operations (`yardstick_rrdb`) over
the device time of the model's operations that are not glue
(`models.rrdb_ms` less `models.rrdb_glue_ms`), whatever implements them."""

import importlib.util
from pathlib import Path

from portbench import yardstick_rrdb
from portbench.trace import select

_spec = importlib.util.spec_from_file_location("portbench.metrics.models_rrdb_glue_ms",
                                               Path(__file__).with_name("models.rrdb_glue_ms.py"))
glue = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(glue)


def read(ctx: dict):
    r, cfg = ctx["record"], ctx["cfg"]
    if "num_grow_ch" not in cfg:
        return None
    conv_us = sum(o["dur"] for o in select(r, under=glue.UNDER) if not glue.is_glue(o))
    if conv_us <= 0:
        return None
    ops = r["frames_in"] * yardstick_rrdb.ops_per_frame(cfg)
    return 100.0 * ops / (conv_us * 1e-6) / yardstick_rrdb.fp16_peak(ctx["kind"])
