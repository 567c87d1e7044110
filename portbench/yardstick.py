"""The yardstick's fixed arithmetic: published peaks, and the operations and
bytes of each kernel and model the cells run, computed from the shapes in a
configuration file. Nothing here reads the program, so a later change to a
kernel cannot move its own bound.

Roofline convention: the least time the chip could take for a launch is the
larger of its operations over the peak rate of its type and its bytes over
the memory rate, each input byte read once and each output byte written once.
"""

from __future__ import annotations

# Published dense peaks (NVIDIA data sheets, no sparsity): device memory
# bytes/s and int8 tensor-core operations/s. The H100 SXM row is the default;
# a kind is matched by the first key it contains.
PEAKS = {
    "H100 PCIe": {"hbm_bytes_s": 2.0e12, "int8_ops_s": 1513e12},
    "H200": {"hbm_bytes_s": 4.8e12, "int8_ops_s": 1979e12},
    "H100": {"hbm_bytes_s": 3.35e12, "int8_ops_s": 1979e12},
}


def peaks(kind: str) -> dict:
    """The peak rates of the card named `kind` (`torch.cuda.get_device_name`)."""
    for key, row in PEAKS.items():
        if key in (kind or ""):
            return row
    return PEAKS["H100"]


def resample_blend_bytes(cfg: dict) -> int:
    """Bytes of one launch of the fused resample + cross-fade: the input frame
    and the previous upscale read once, the upscale and each mid written once
    (RGBA u8). The tap tables (under 0.2 MB) are left out, which only lowers
    the bound."""
    px_in = cfg["in_h"] * cfg["in_w"] * 4
    px_out = cfg["out_h"] * cfg["out_w"] * 4
    return px_in + px_out + px_out * (1 + len(cfg["time_t"]))


def esrgan_convs(cfg: dict) -> list[tuple[str, int, int]]:
    """(name, Cin, Cout) of every conv of the s2d ESRGAN-lite graph at the
    checkpoint's real widths: the head on the RGB s2d, the blocks' two convs,
    the trunk, the tail to the RGB phases, and the fixed bilinear base from
    the RGB s2d to the RGB phases (run as a conv on the int8 grid)."""
    st, f, up = cfg["stride"], cfg["features"], cfg["upscale"]
    rgb_in = st * st * 3
    rgb_phases = (st * up) ** 2 * 3
    convs = [("head", rgb_in, f)]
    for i in range(cfg["blocks"]):
        convs += [(f"block{i}/conv1", f, f), (f"block{i}/conv2", f, f)]
    convs += [("trunk", f, f), ("tail", f, rgb_phases), ("base", rgb_in, rgb_phases)]
    return convs


def conv_positions(cfg: dict) -> int:
    """Trunk positions a frame: the input frame over the s2d stride."""
    return (cfg["in_h"] // cfg["stride"]) * (cfg["in_w"] // cfg["stride"])


def conv_ops(positions: int, cin: int, cout: int) -> int:
    """Operations of a 3x3 conv: a multiply and an add per tap, channel pair
    and position."""
    return 2 * 9 * cin * cout * positions


def conv_q_bytes(positions: int, cin: int, cout: int) -> int:
    """Bytes of a 3x3 conv on the int8 grid: the quantised input (1 byte) and
    the int8 weights read once, an fp32 scale and bias a channel, the output
    written once in bf16 (2 bytes), as the graph rounds every conv to bf16."""
    return positions * cin + 9 * cin * cout + 8 * cout + 2 * positions * cout


def esrgan_ops_per_frame(cfg: dict) -> int:
    """The model's operations a frame at its real widths."""
    pos = conv_positions(cfg)
    return sum(conv_ops(pos, cin, cout) for _, cin, cout in esrgan_convs(cfg))


def conv_q_bound_s(cfg: dict, kind: str) -> float:
    """Least seconds of a frame's int8-grid convs on `kind`: the sum over the
    convs of the larger of their operations over the int8 peak and their
    bytes over the memory rate."""
    p = peaks(kind)
    pos = conv_positions(cfg)
    return sum(max(conv_ops(pos, cin, cout) / p["int8_ops_s"],
                   conv_q_bytes(pos, cin, cout) / p["hbm_bytes_s"])
               for _, cin, cout in esrgan_convs(cfg))
