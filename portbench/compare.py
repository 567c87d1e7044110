"""The comparison that decides `correct`: the payloads the timed path fetched
for the sampled frames, against the reference's payloads of the same input
frames.

The reference works every frame out again from the inputs the benchmark made:
the link's input conversion, the configuration's upscale (and mids), the
link's output conversion. Each sampled payload plane is compared byte for
byte; the numbers are the largest difference in LSB (`max_abs_lsb`) and the
share of bytes that differ at all (`mismatch_pct`). A cell's limits file names
the numbers it is held to, each with its limit.
"""

from __future__ import annotations

import torch


def compare(kept: dict, host_inputs: list, ref, link_ref, links, device) -> dict:
    """Readings over every sampled frame's payloads. `kept` maps a frame index
    to the payloads the program fetched; input i is `host_inputs[i % K]`."""
    k = len(host_inputs)
    ups: dict = {}

    def up(c: int) -> torch.Tensor:
        if c not in ups:
            ups[c] = ref.upscale(link_ref.ingest(host_inputs[c]))
        return ups[c]

    worst, differ, total, frames, shape_ok = 0, 0, 0, 0, True
    for i in sorted(kept):
        expected = ref.payloads(up((i - 1) % k) if i > 0 else None, up(i % k))
        got = kept[i]
        if len(got) != len(expected):
            shape_ok = False
            continue
        for payload, exp in zip(got, expected):
            for plane, want in zip(links.planes(payload), link_ref.deliver(exp)):
                p = torch.from_numpy(plane).to(device)
                if p.shape != want.shape:
                    shape_ok = False
                    continue
                d = (p.to(torch.int16) - want.to(torch.int16)).abs()
                worst = max(worst, int(d.max().item()))
                differ += int((d != 0).sum().item())
                total += d.numel()
        frames += 1
    return {
        "frames": frames,
        "shapes_match": shape_ok,
        "max_abs_lsb": float(worst),
        "mismatch_pct": 100.0 * differ / total if total else 100.0,
    }


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(whether every number the limits name is within its limit, and the
    numbers with their limits)."""
    compared = {name: {"value": readings[name], "limit": spec["limit"]}
                for name, spec in limits["numbers"].items()}
    ok = (readings["frames"] > 0 and readings["shapes_match"]
          and all(c["value"] <= c["limit"] for c in compared.values()))
    return ok, compared
