"""The yardstick of the RRDBNet cells: the real-width multiply-adds of a
frame and the card's dense fp16 peak. Fixed arithmetic from the
configuration's shapes; nothing here reads the program, so a later change to
how the convs run cannot move its own bound."""

from __future__ import annotations

# Published dense fp16 tensor-core peaks (NVIDIA data sheets, no sparsity),
# operations/s; a kind is matched by the first key it contains, the H100 SXM
# row by default.
FP16_PEAKS = {"H100 PCIe": 756e12, "H200": 989e12, "H100": 989e12}


def fp16_peak(kind: str) -> float:
    for key, rate in FP16_PEAKS.items():
        if key in (kind or ""):
            return rate
    return FP16_PEAKS["H100"]


def convs(cfg: dict) -> list[tuple[str, int, int, int]]:
    """(name, Cin, Cout, positions) of every 3x3 conv of a frame at the real
    widths: the first conv and the body at the unshuffled size, the two
    upsampling convs at 2x and 4x of it, then the HR conv and the last."""
    f, g, s = cfg["num_feat"], cfg["num_grow_ch"], cfg["scale"]
    unshuffle = {4: 1, 2: 2, 1: 4}[s]
    lo = (cfg["in_h"] // unshuffle) * (cfg["in_w"] // unshuffle)
    out = [("conv_first", cfg["num_in_ch"] * unshuffle ** 2, f, lo)]
    for i in range(cfg["num_block"]):
        for j in (1, 2, 3):
            out += [(f"body.{i}.rdb{j}.conv{k}", f + (k - 1) * g, g, lo) for k in range(1, 5)]
            out.append((f"body.{i}.rdb{j}.conv5", f + 4 * g, f, lo))
    out += [("conv_body", f, f, lo), ("conv_up1", f, f, 4 * lo), ("conv_up2", f, f, 16 * lo),
            ("conv_hr", f, f, 16 * lo), ("conv_last", f, cfg["num_out_ch"], 16 * lo)]
    return out


def macs_per_frame(cfg: dict) -> int:
    """Multiply-adds of a frame: 9 taps per input-output channel pair and
    position."""
    return sum(9 * cin * cout * pos for _, cin, cout, pos in convs(cfg))


def ops_per_frame(cfg: dict) -> int:
    """Operations of a frame: a multiply and an add per multiply-add."""
    return 2 * macs_per_frame(cfg)
