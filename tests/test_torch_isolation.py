"""The port stands alone: importing it pulls in nothing of the JAX side, no
module of it imports the JAX side, and it never falls back to the CPU when
the card is asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nu_scaler_tpu_torch
from nu_scaler_tpu_torch import core
from nu_scaler_tpu_torch.kernels import _build
from nu_scaler_tpu_torch.ops import resample

PKG = Path(nu_scaler_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nu_scaler_tpu", "nu_scaler_core")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_leaves_jax_side_out():
    code = (
        "import sys, nu_scaler_tpu_torch, nu_scaler_tpu_torch.core, "
        "nu_scaler_tpu_torch.runtime.streaming, nu_scaler_tpu_torch.kernels._build, "
        "nu_scaler_tpu_torch.models.esrgan_lite, nu_scaler_tpu_torch.kernels.conv_cuda, "
        "nu_scaler_tpu_torch.kernels.trunk_cuda, "
        "nu_scaler_tpu_torch.runtime.detector, nu_scaler_tpu_torch.runtime.memory, "
        "nu_scaler_tpu_torch.runtime.framering, nu_scaler_tpu_torch.capture.video, "
        "nu_scaler_tpu_torch.run, nu_scaler_tpu_torch.models.train, nu_scaler_tpu_torch.models.data, "
        "nu_scaler_tpu_torch.parallel.mesh, nu_scaler_tpu_torch.parallel.tp; "
        "print('\\n'.join(sys.modules))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=PKG.parent,
    )
    assert proc.returncode == 0, proc.stderr
    loaded = [m for m in proc.stdout.split() if _forbidden(m)]
    assert loaded == []


def test_training_writes_only_under_its_own_root():
    """The trainers' CKPT_ROOT (checkpoints_torch/ at the root of the
    checkout) lies outside the JAX package's checkpoints/ and the port's
    committed weights, and .gitignore lists it; the refinement net's named
    checkpoints live under it."""
    from nu_scaler_tpu_torch.models import esrgan_lite, interp_refine, train

    root = PKG.parent
    ckpt = Path(train.CKPT_ROOT).resolve()
    assert ckpt == root / "checkpoints_torch"
    for other in (root / "checkpoints", esrgan_lite.WEIGHTS_DIR.resolve()):
        assert not ckpt.is_relative_to(other) and not other.is_relative_to(ckpt)
    assert interp_refine._ckpt_dir("t").parent == ckpt
    ignored = [ln.strip().rstrip("/") for ln in (root / ".gitignore").read_text().splitlines()]
    assert ckpt.name in ignored


def test_no_source_imports_jax_side():
    paths = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py",
                                          PKG.parent / "tools" / "sharded_train_probe.py"]
    assert len(paths) >= 10
    for path in paths:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nu_scaler_tpu_torch.default_device()
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            nu_scaler_tpu_torch.resolve_device(dev)
    with pytest.raises(RuntimeError):
        core.PyWgpuUpscaler("ultra", "lanczos3")
    with pytest.raises(RuntimeError):
        core.WgpuFrameInterpolator()
    with pytest.raises(RuntimeError):
        resample.make_resampler(8, 8, 16, 16, "lanczos3")
    assert nu_scaler_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        nu_scaler_tpu_torch.resolve_device("meta")


def test_learned_tier_needs_a_card_by_default(monkeypatch):
    """The learned tier and the advanced upscaler default to the card and
    raise without one; the conv launcher refuses a CPU tensor."""
    from nu_scaler_tpu_torch.kernels import conv_cuda
    from nu_scaler_tpu_torch.models import esrgan_lite

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        core.create_advanced_upscaler("ultra")
    with pytest.raises(RuntimeError, match="CUDA device"):
        esrgan_lite.make_pretrained_upscaler(32, 64, 64, 128, "ultra")
    x = torch.zeros((1, 4, 4, 128), dtype=torch.bfloat16)
    k = torch.zeros((3, 3, 128, 128), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        conv_cuda._launch(x, k, k[0, 0, 0].contiguous(), False, True)


def test_kernel_launch_needs_a_cuda_tensor():
    """The launcher refuses anything but a CUDA tensor before it builds."""
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc

    plan = rc.ResamplePlan(
        resample.axis_weights(8, 16, "nearest"), resample.axis_weights(8, 16, "nearest"), "cpu"
    )
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        rc._launch(torch.zeros((8, 8, 4), dtype=torch.uint8), 1, plan)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc the loader raises a clear error instead of falling back;
    each source gets its own library path, keyed by its hash, under build/."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build.load_library.cache_clear()
    try:
        for name in _build.SIGNATURES:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                _build.load_library(name)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
    finally:
        _build.load_library.cache_clear()
    paths = {name: _build.library_path(name) for name in _build.SIGNATURES}
    assert sorted(paths) == ["conv3x3", "fsr", "resample_fused", "resample_twopass", "rrdb_conv",
                             "soft_warp", "trunk_fused"]
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == tmp_path and path.name.startswith(f"lib{name}_")
        assert _build.source_path(name).is_file() and _build.source_path(name).suffix == ".cu"
    with pytest.raises(ValueError, match="unknown kernel library"):
        _build.library_path("bogus")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_library_key_follows_its_own_source(monkeypatch, tmp_path):
    """Changing one source changes its library's name and no other's; a
    shared header changes the names of the libraries that include it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    before = {name: _build.library_path(name).name for name in _build.SIGNATURES}
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert {name: _build.library_path(name).name for name in _build.SIGNATURES} == before
    (csrc / "soft_warp.cu").write_text((csrc / "soft_warp.cu").read_text() + "\n// changed\n")
    after = {name: _build.library_path(name).name for name in _build.SIGNATURES}
    assert after["resample_fused"] == before["resample_fused"]
    assert after["soft_warp"] != before["soft_warp"]
    (csrc / "conv3x3_core.cuh").write_text((csrc / "conv3x3_core.cuh").read_text() + "\n// changed\n")
    shared = {name: _build.library_path(name).name for name in _build.SIGNATURES}
    assert {name for name in shared if shared[name] != after[name]} == {"conv3x3", "trunk_fused"}


def test_import_compiles_nothing(tmp_path):
    """Importing every module of the port starts no nvcc and builds no
    library: the build happens at the first CUDA launch."""
    code = (
        "import pkgutil, importlib, subprocess, nu_scaler_tpu_torch as p\n"
        "calls = []\n"
        "orig = subprocess.Popen.__init__\n"
        "def spy(self, *a, **k):\n"
        "    calls.append(a)\n"
        "    orig(self, *a, **k)\n"
        "subprocess.Popen.__init__ = spy\n"
        "from nu_scaler_tpu_torch.kernels import _build\n"
        f"_build.BUILD_DIR = __import__('pathlib').Path({str(tmp_path)!r})\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nu_scaler_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(len(calls), _build.load_library.cache_info().currsize)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=PKG.parent,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "0"]
    assert list(tmp_path.iterdir()) == []


def test_kernel_source_is_plain_c():
    """One CUDA source per library (the conv and the fused trunk share the
    conv's main loop in one header), no PyTorch headers, a C entry point per
    wrapper call; every fp32 rounding written out, and each packing as its
    golden packs: the resample truncates and its blend rounds (by adding 2^23
    toward zero and to nearest; the two-pass resample sums with the fused
    kernel's fmaf and truncates the same way), the soft warp rounds (adding 2^23 to
    nearest), FSR truncates (adding 2^23 toward zero), the conv and the
    fused trunk round to bf16 to
    nearest (their products and sums are the tensor cores' own, fp32
    accumulation; the trunk's skip additions are written out). The conv and
    the trunk run on warpgroup MMAs fed by cp.async, with no WMMA left in
    them; the trunk is one cooperative launch. RRDBNet's conv runs on
    warpgroup MMAs fed by cp.async and rounds its written-out epilogue to
    fp16."""
    sources = sorted(p.name for p in PKG.rglob("*.cu*"))
    assert sources == ["conv3x3.cu", "conv3x3_core.cuh", "device_guard.cuh", "fsr.cu",
                       "resample_fused.cu", "resample_twopass.cu", "rrdb_conv.cu", "soft_warp.cu",
                       "trunk_fused.cu"]
    written_out = ("__fmul_rn", "__fadd_rn")
    packing = {
        "resample_fused": (*written_out, "__fadd_rz", "fmaf", "cp.async"),
        "soft_warp": (*written_out, "8388608.0f"),
        "fsr": (*written_out, "__fadd_rz", "8388608.0f"),
        "conv3x3": ("__fadd_rn", "__float2bfloat16_rn", "wgmma.mma_async", "cp.async"),
        "resample_twopass": ("fmaf", "__fadd_rz", "8388608.0f"),
        "trunk_fused": (*written_out, "__float2bfloat16_rn", "wgmma.mma_async",
                        "cudaLaunchCooperativeKernel"),
        "rrdb_conv": (*written_out, "__floats2half2_rn", "wgmma.mma_async", "cp.async"),
    }
    assert sorted(packing) == sorted(_build.SIGNATURES)
    for name, fns in _build.SIGNATURES.items():
        text = "".join(path.read_text() for path in _build.source_files(name))
        assert "torch/extension.h" not in text and "#include <torch" not in text
        assert 'extern "C"' in text and "nu_cuda_error_string" in text
        assert all(fn in text for fn in fns)
        assert np.all([s in text for s in packing[name]])
    for name in ("conv3x3", "trunk_fused"):
        assert not any("wmma::" in path.read_text() for path in _build.source_files(name))
    fsr = _build.source_path("fsr").read_text()
    assert np.all([s in fsr for s in ("__fsub_rn", "__fdiv_rn", "__fsqrt_rn")])


def _c_entries(text: str) -> dict:
    """{name: body} of every ``int nu_*(...) {...}`` function in `text`."""
    import re

    out = {}
    for m in re.finditer(r"^int (nu_\w+)\([^)]*\)\s*\{", text, re.MULTILINE):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        out[m.group(1)] = text[m.end():i - 1]
    return out


def test_kernel_entries_restore_the_device():
    """Every C entry gives the calling thread's current device back: each
    one that launches holds a `DeviceGuard` (csrc/device_guard.cuh: the
    device saved with cudaGetDevice, the named one set, the saved one set
    again in its destructor), or delegates to an entry that does; no entry
    calls cudaSetDevice itself. Otherwise a launch on cuda:1 would leave
    `torch.cuda.current_device()` at 1 for the caller's next call that
    names no card (`device._card`)."""
    guard = (PKG / "kernels" / "csrc" / "device_guard.cuh").read_text()
    ctor, dtor = guard.split("~DeviceGuard()")
    assert "cudaGetDevice(&previous)" in ctor and "cudaSetDevice(device)" in ctor
    assert "cudaSetDevice(previous)" in dtor
    entries = {}
    for name in _build.SIGNATURES:
        text = "".join(path.read_text() for path in _build.source_files(name))
        assert '#include "device_guard.cuh"' in text
        entries.update(_c_entries(text))
    assert sorted(entries) == sorted(fn for fns in _build.SIGNATURES.values() for fn in fns)
    for fn, body in entries.items():
        assert "cudaSetDevice" not in body, fn
        delegates = [other for other in entries if other != fn and f"{other}(" in body]
        assert "const DeviceGuard guard(device);" in body or delegates, fn


def _pyproject() -> dict:
    import tomllib

    return tomllib.loads((PKG.parent / "pyproject.toml").read_text())["tool"]["setuptools"]


@pytest.mark.parametrize("sub", sorted(p.parent.relative_to(PKG.parent).as_posix().replace("/", ".")
                                       for p in PKG.rglob("__init__.py")))
def test_pyproject_names_every_subpackage(sub):
    """A non-editable install carries every package of the port: `packages`
    names each directory that holds an `__init__.py`."""
    assert sub in _pyproject()["packages"]


def test_pyproject_ships_kernel_sources_and_weights():
    """The package data carries every kernel source and header the build
    reads, the host libraries' C++ sources and every committed weight file."""
    from fnmatch import fnmatch

    data = _pyproject()["package-data"]
    owners = (("nu_scaler_tpu_torch.kernels", PKG / "kernels", (".cu", ".cuh")),
              ("nu_scaler_tpu_torch.runtime.native", PKG / "runtime" / "native", (".cpp",)),
              ("nu_scaler_tpu_torch", PKG, (".npz", ".json")))
    shipped = [(p.relative_to(root).as_posix(), data.get(pkg, []))
               for pkg, root, suffixes in owners for p in root.rglob("*")
               if p.is_file() and p.suffix in suffixes]
    assert len(shipped) >= 9
    assert {rel for rel, _ in shipped} >= {"framering.cpp", "y4m.cpp"}
    for rel, globs in shipped:
        assert any(fnmatch(rel, g) for g in globs), f"{rel} is not in the package data"


@pytest.mark.parametrize("layer", ["constants.py", "device.py", "kernels", "ops", "models", "runtime", "utils",
                                   "capture", "bench"])
def test_layers_below_the_api_do_not_import_it(layer):
    """The API layer (`core`) imports the layers below it and none of them
    imports `core`: no cycle through `core/__init__`."""
    root = PKG / layer
    paths = [root] if root.is_file() else sorted(root.rglob("*.py"))
    assert paths
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            assert not any(n == "nu_scaler_tpu_torch.core" or n.startswith("nu_scaler_tpu_torch.core.")
                           for n in names), f"{path}:{node.lineno} imports the API layer"
