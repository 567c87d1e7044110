"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and its control's (the reference put in the program's place and
computed in the precision below the configuration's), in one process.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 [--control-seeds 4,5,6] [--seconds 2]

Prints one JSON line a run: {"workload", "seed", "side": "program" | "control",
"correct", "failed", "attempted", "compared": {...}}. It needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import registry
from portbench.run import run_cell, set_cache_dirs


def control_fns(mix: dict):
    """`run_cell`'s `step_fns` for the control: the configuration's reference
    and the link's conversions, in the precision below the configuration's."""

    def fns(cfg: dict, device, scratch) -> dict:
        out = registry.reference(cfg["reference"]).Reference(cfg, device, control=True).step_fn()
        out.update(registry.link(mix["link"]).control(device))
        return out

    return fns


def readings(cell: dict, seed: int, seconds: float, device, control: bool, bench: dict) -> dict:
    mix = registry.traffic(cell["traffic"])
    r = run_cell(cell, seed, seconds, False, device, time.perf_counter(), mix=mix,
                 step_fns=control_fns(mix) if control else None, bench=bench)
    return {"workload": cell["name"], "seed": seed, "side": "control" if control else "program",
            "correct": r["correct"], "failed": r["failed"], "attempted": r["attempted"],
            "compared_frames": r["compared_frames"],
            "compared": {k: v["value"] for k, v in r["compared"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    device = torch.device("cuda", 0)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            print(json.dumps(readings(cell, int(s), args.seconds, device, control, bench)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
