"""The launcher (nu_scaler_tpu_torch/run.py): the app (`nu_scaler`),
unmodified, on the port, against the app on the JAX package, on the CPU.

One subprocess runs, through `serve_port("cpu")` and `run_app`, the app's
transcode of a 4-frame 32×48 clip on four paths, its benchmark CLI and a
live session, and lists the modules it loaded; the test's own process runs
JAX's `nu_scaler.transcode.transcode` on the same clip. The output files'
headers and frame counts are equal, and every decoded frame is within its
path's bound of JAX's. The bounds are the port's RGB bounds against JAX on
each path, carried through the 4:2:0 file: the Y4M writer's planes are sums
of the RGB values with coefficients of magnitude ≤ 1 (a 1-LSB change of RGB
moves each plane by ≤ 1 after truncation), and the reader's RGB adds a V
term ×1.402 and a U term ×1.772 to Y, so d LSB of RGB come back as at most
3·d + 1 LSB:
- the resample (lanczos3, bilinear, batched or not): ≤ 1 LSB of RGB
  (tests/test_torch_resample.py) → 4;
- the cross-fade mid, upscaled: blend ≤ 1 and resample ≤ 1 → 2 → 7;
- flow_soft on a frame the warp tile does not divide (the ragged branch),
  upscaled: mid ≤ 1 (tests/test_torch_flow.py) and resample ≤ 1 → 7;
- FSR at ×2: ≤ 1 LSB outside the EASU cut-off ties, ≤ 8 at them
  (tests/test_torch_fsr.py) → 25.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nu_scaler_tpu_torch import device as pdevice
from nu_scaler_tpu_torch import run
from nu_scaler_tpu_torch.capture.video import Y4MReader, Y4MWriter

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax")
JAX_DIRS = (str(ROOT / "nu_scaler_tpu") + os.sep, str(ROOT / "nu_scaler_core") + os.sep)
# case: (the app's transcode arguments, JAX transcode's keywords, bound in LSB)
CASES = {
    "wgpu blend x2": (["--algorithm", "bilinear", "--factor", "2", "--interp-mode", "blend"],
                      dict(algorithm="bilinear", factor=2, interp_mode="blend"), 7),
    "wgpu flow_soft x2": (["--algorithm", "lanczos3", "--factor", "2", "--interp-mode", "flow_soft"],
                          dict(algorithm="lanczos3", factor=2, interp_mode="flow_soft"), 7),
    "fsr": (["--tech", "fsr", "--quality", "quality"], dict(technology="fsr", quality="quality"), 25),
    "wgpu batch 2": (["--algorithm", "lanczos3", "--batch", "2"], dict(algorithm="lanczos3", batch=2), 4),
}

SCRIPT = r"""
import contextlib, io, json, sys, time
from nu_scaler_tpu_torch import run

src, out_dir, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
result = {"rc": {}}
with run.serve_port("cpu"):
    for name, args in cases.items():
        result["rc"][name] = run.run_app("nu_scaler.transcode", [src, f"{out_dir}/{name}.y4m", *args])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        result["rc"]["bench"] = run.run_app("nu_scaler.benchmark_app", [
            "single", "--tech", "auto", "--width", "64", "--height", "48", "--scale", "2", "--frames", "3"])
    result["bench"] = text.getvalue()

    import nu_scaler_core
    from nu_scaler.live import LiveSession

    frames = []
    session = LiveSession(
        scale=2.0, algorithm="bilinear", quality="performance",
        target=nu_scaler_core.PyCaptureTarget.Region, region=nu_scaler_core.PyRegion(0, 0, 320, 240),
        sink=lambda d, w, h: frames.append((len(d), w, h)), fps=30,
    ).start()
    deadline = time.monotonic() + 60
    while len(frames) < 3 and time.monotonic() < deadline:
        time.sleep(0.05)
    session.stop()
    result["live"] = {"stats": repr(session.stats()), "first": frames[:1],
                      "ring": type(session.capture._inner._ring).__name__,
                      "core": nu_scaler_core.__spec__.name}
    result["modules"] = {n: getattr(m, "__file__", None) for n, m in list(sys.modules.items())}
print(json.dumps(result))
"""


def _clip(path, n=4, h=32, w=48):
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (h, w, 4), np.uint8)
    base[8:16, 8:16, :3] = 255
    writer = Y4MWriter(str(path), w, h, fps=30)
    for i in range(n):
        writer.write(np.roll(base, 2 * i, axis=1))
    writer.close()


def _env(tmp):
    env = dict(os.environ, XDG_DATA_HOME=str(tmp / "xdg"))
    env.pop("DISPLAY", None)
    return env


@pytest.fixture(scope="module")
def app_run(tmp_path_factory):
    """The subprocess's JSON, and its clip and output directory."""
    tmp = tmp_path_factory.mktemp("app")
    src = tmp / "in.y4m"
    _clip(src)
    cases = {name: args for name, (args, _, _) in CASES.items()}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(src), str(tmp), json.dumps(cases)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT, env=_env(tmp))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), tmp


@pytest.mark.parametrize("case", list(CASES))
def test_transcode_matches_jax(app_run, case):
    from nu_scaler.transcode import transcode

    result, tmp = app_run
    args, kwargs, bound = CASES[case]
    assert result["rc"][case] == 0
    want_path = tmp / f"{case} jax.y4m"
    if not want_path.exists():
        transcode(str(tmp / "in.y4m"), str(want_path), scale=2.0, **kwargs)
    got, want = Y4MReader(str(tmp / f"{case}.y4m")), Y4MReader(str(want_path))
    with open(tmp / f"{case}.y4m", "rb") as f, open(want_path, "rb") as g:
        assert f.readline() == g.readline()  # the header: size, rate, chroma
    got_frames, want_frames = list(got), list(want)
    factor = kwargs.get("factor", 1)
    assert len(got_frames) == len(want_frames) == factor * (4 - 1) + 1
    worst = max(int(np.abs(a.astype(int) - b).max()) for a, b in zip(got_frames, want_frames))
    print(f"{case}: max {worst} LSB over {len(got_frames)} frames (bound {bound})")
    assert worst <= bound
    for frame in got_frames:
        assert frame.shape == (64, 96, 4)


def test_app_loads_nothing_of_the_jax_side(app_run):
    result, _ = app_run
    loaded = result["modules"]
    assert "nu_scaler_core" in loaded and "nu_scaler.transcode" not in loaded  # run as __main__
    assert loaded["nu_scaler_core"] == loaded["nu_scaler_tpu_torch.core"]
    assert loaded["nu_scaler_tpu.capture.video"].endswith("nu_scaler_tpu_torch/capture/video.py")
    assert [n for n in loaded if n.split(".")[0] in FORBIDDEN] == []
    assert [n for n, f in loaded.items() if f and f.startswith(JAX_DIRS)] == []


def test_benchmark_app_prints_a_result(app_run):
    result, _ = app_run
    assert result["rc"]["bench"] == 0
    line = result["bench"].strip().splitlines()[-1]
    # "auto" is "fallback" without a card ("wgpu" with one, as --device cpu may run there)
    assert re.match(r"WgpuUpscaler \[(Fallback|Wgpu)/Balanced\] 64x48→128x96: [0-9.]+ fps ", line), line
    assert float(line.split(": ")[1].split(" fps")[0]) > 0


def test_live_session_on_a_region(app_run):
    """The app's LiveSession (capture → upscale on the live thread) with a
    Region target, as tests/test_app_layer.py drives it on JAX."""
    live = app_run[0]["live"]
    stats = ast.literal_eval(live["stats"])
    assert stats["errors"] == 0 and stats["frames_out"] >= 3 and stats["input_size"] == (320, 240)
    assert live["first"] == [[640 * 480 * 4, 640, 480]]
    assert live["ring"] == "NativeFrameRing" and live["core"] == "nu_scaler_tpu_torch.core"


def test_module_cli_and_the_apps_cpu_flag(tmp_path):
    """`python -m nu_scaler_tpu_torch.run` passes the app's exit code on; the
    app's own --cpu imports jax, which the launcher refuses with a message
    naming its --device cpu."""
    src = tmp_path / "in.y4m"
    _clip(src, n=2)
    cmd = [sys.executable, "-m", "nu_scaler_tpu_torch.run", "--device", "cpu", "nu_scaler.transcode",
           str(src), str(tmp_path / "out.y4m"), "--algorithm", "nearest"]
    ok = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=ROOT, env=_env(tmp_path))
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert "'frames_out': 2" in ok.stdout
    bad = subprocess.run(cmd + ["--cpu"], capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=_env(tmp_path))
    assert bad.returncode != 0
    assert "ModuleNotFoundError: jax is not served" in bad.stderr and "--device cpu" in bad.stderr


def test_serve_port_refuses_unported_imports_and_restores():
    """In this process (which holds the JAX package): inside the block the
    aliases are the port's and an unported module raises naming itself;
    after it, the JAX side's modules are back and the default device is
    the card again."""
    import importlib

    import nu_scaler_core as jax_core

    assert pdevice._default is None
    with run.serve_port("cpu") as finder:
        assert sys.meta_path[0] is finder
        assert pdevice.resolve_device(None).type == "cpu"
        core = importlib.import_module("nu_scaler_core")
        assert core.__name__ == "nu_scaler_tpu_torch.core" and core.__spec__.name == core.__name__
        video = importlib.import_module("nu_scaler_tpu.capture.video")
        assert video.__name__ == "nu_scaler_tpu_torch.capture.video"
        assert sys.modules["nu_scaler_tpu"].__path__ == []
        # a submodule of a refused package is refused at its parent
        for name, refused in (("nu_scaler_tpu.ops", "nu_scaler_tpu.ops"),
                              ("nu_scaler_tpu.capture.screen", "nu_scaler_tpu.capture.screen"),
                              ("nu_scaler_core.facade", "nu_scaler_core.facade"), ("jax", "jax"),
                              ("flax.linen", "flax")):
            with pytest.raises(ImportError, match=f"^{refused} is not served"):
                importlib.import_module(name)
    assert finder not in sys.meta_path and pdevice._default is None
    assert sys.modules["nu_scaler_core"] is jax_core
    assert importlib.import_module("nu_scaler_tpu.capture.video").__name__ == "nu_scaler_tpu.capture.video"


def test_default_device_is_set_only_on_request(monkeypatch):
    """`set_default_device` is what `resolve_device(None)` reads; unset, it
    is the card, which raises without one."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pdevice, "_default", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdevice.resolve_device(None)
    pdevice.set_default_device("cpu")
    assert pdevice.resolve_device(None) == pdevice.default_device() == torch.device("cpu")
    assert pdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        pdevice.resolve_device("cuda")
    pdevice.set_default_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        pdevice.resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        pdevice.set_default_device("meta")
    pdevice.set_default_device(None)
    assert pdevice._default is None
