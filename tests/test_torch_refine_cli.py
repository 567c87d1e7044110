"""The port's command lines of the trainers against the JAX package's, on the
CPU: `python -m nu_scaler_tpu_torch.models.interp_refine` (the refinement
net: train, distill, --calibrate, --eval) against JAX's
`nu_scaler_tpu/models/interp_refine.py:742-818`, and `--calibrate --io` of
`python -m nu_scaler_tpu_torch.models.train` against JAX's `train.py:380-446`.

JAX's command lines run themselves, as ``python -m`` runs them (`runpy`,
``run_name="__main__"``, `sys.argv` set). JAX's interp_refine binds its
`CKPT_ROOT` and `CKPT_DIR` from `nu_scaler_tpu.models.train.CKPT_ROOT` when it
runs, so that attribute points at ``tmp_path/checkpoints``; JAX's train.py
binds its own `CKPT_ROOT` from its file's path, so its command line runs
from a byte copy of the file under ``tmp_path`` (its root is then
``tmp_path/checkpoints`` too). That root holds copies of the committed orbax
checkpoints a test needs; the port's `CKPT_ROOT` starts empty, so the port
resolves the committed export of the same step.

Where a command line renders a `TripletPool`, the soft warp's mid is
replaced on both sides by the integer mean of A and B (exact in both
packages), so both sides draw the same crops from the same clips; the soft
warp itself is held against JAX's in `tests/test_torch_refine_train.py`.

Bounds:

* a 2-step leg and a 2-step distillation leg: the losses as both command
  lines print them (JAX's format, 5 decimals) within 1e-5, one unit of the
  last digit; the saved parameters within the training tests' bound
  (`tests/test_torch_train.py`: 99.9% within 1e-6, all within 6·lr);
* the int8 scales of ``--calibrate`` (with and without the head): relative
  1e-5, as `test_calibrate_scales_match_jax` (measured: at most 2e-7); of
  the SR ``--calibrate --io``: relative 1e-5, as
  `test_calibrate_trunk_scales_match_jax`;
* ``--eval`` and `eval_refine_float`: the PSNRs within 0.05 dB and the SSIMs
  within 1e-3 (`chip_smoke.py`'s `EVAL_GATE`; measured: equal to the last
  printed digit, and the dicts equal);
* what "flow_soft_ref" serves after a calibration, against JAX serving its
  own calibration of the same step: the refined mid against JAX's graph run
  op by op ≥ 50 dB RGB with alpha equal (`tests/test_torch_checkpoints.py`;
  measured: bit-equal). The learned tier's int8 graph on the calibrated
  step is held against JAX's in `tests/test_torch_int8.py`; here it is
  checked to serve that step from the copy, with its scales.

Everything is written under `tmp_path`; the committed weights'
(``nu_scaler_tpu_torch/weights/``) bytes, ``checkpoints/`` and
``checkpoints_torch/`` are checked unchanged after each test.
"""

import argparse
import contextlib
import hashlib
import json
import re
import runpy
import shutil
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nu_scaler_tpu.ops.interpolate as JI
from nu_scaler_tpu.models import esrgan_lite as jel
from nu_scaler_tpu.models import interp_refine as jir
from nu_scaler_tpu.models import train as jtrain
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch.models import esrgan_lite as el
from nu_scaler_tpu_torch.models import interp_refine as pir
from nu_scaler_tpu_torch.models import train as ptrain
from nu_scaler_tpu_torch.ops import interpolate as P

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = el.WEIGHTS_DIR  # the committed weights, whatever a test patches
LR = 2e-4
EVAL_GATE = (0.05, 1e-3)  # dB, SSIM
# a leg at 128x256: one clip, 8 crops of 96^2 (TripletPool's crop)
LEG = ["--batch", "2", "--clips", "1", "--pool", "8", "--height", "128", "--width", "256"]
PORT_CACHES = (el._cached_model, el._build_pretrained, pir.load_model, pir._refine_graph, P._interpolator,
               P._multi_interpolator, P._refined_mid_upscaler, P._refined_multi_upscaler)
JAX_CACHES = (jel.make_pretrained_upscaler, jel.make_fast_upscaler, jir.get_refine_graph,
              jir.get_refine_phase_graph, jir._make_refine_fn)


def _clear_caches() -> None:
    for fn in PORT_CACHES + JAX_CACHES:
        fn.cache_clear()


def _state() -> list:
    """The committed weights' bytes, and every file under checkpoints/ and
    checkpoints_torch/ with its mtime."""
    weights = sorted((p.name, hashlib.sha256(p.read_bytes()).hexdigest()) for p in WEIGHTS.iterdir())
    dirs = [sorted((p.relative_to(d).as_posix(), p.stat().st_mtime_ns) for p in d.rglob("*")) if d.exists() else None
            for d in (ROOT / "checkpoints", ROOT / "checkpoints_torch")]
    return [weights, *dirs]


def _copy_orbax(name: str, jroot: Path) -> None:
    """Copy the committed orbax checkpoint `name` (its latest.txt and the step
    it names) into JAX's root."""
    src, dst = ROOT / "checkpoints" / name, jroot / name
    step = (src / "latest.txt").read_text().strip()
    dst.mkdir(parents=True)
    shutil.copy2(src / "latest.txt", dst / "latest.txt")
    shutil.copytree(src / step, dst / step)


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """(JAX's CKPT_ROOT, the port's) under tmp_path, both empty; the loaders'
    caches cleared before and after; nothing written elsewhere."""
    jroot, proot = tmp_path / "checkpoints", tmp_path / "port"
    jroot.mkdir()
    monkeypatch.setattr(jtrain, "CKPT_ROOT", str(jroot))
    monkeypatch.setattr(jir, "CKPT_ROOT", str(jroot))
    monkeypatch.setattr(jir, "CKPT_DIR", str(jroot / "interp_ref4"))
    monkeypatch.setattr(ptrain, "CKPT_ROOT", proot)
    before = _state()
    _clear_caches()
    yield jroot, proot
    _clear_caches()
    assert _state() == before


@contextlib.contextmanager
def _mean_mids():
    """Both packages' soft warp, as `TripletPool` calls it, replaced by the
    integer mean of A and B: the same mids, so the same crops."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JI, "soft_interp_fast", lambda a, b, t: ((a.astype(jnp.uint16) + b) // 2).astype(jnp.uint8))
        m.setattr(P, "soft_interp_fast", lambda a, b, t: ((a.to(torch.int16) + b) // 2).to(torch.uint8))
        yield


@pytest.fixture
def mean_mids():
    with _mean_mids():
        yield


def _jax_cli(module: str, argv: list, capsys, path=None) -> str:
    """Run JAX's command line `module` with `argv` as ``python -m`` runs it
    (from the file `path` when given); returns what it printed."""
    capsys.readouterr()
    with contextlib.ExitStack() as stack:
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore", RuntimeWarning)  # runpy: the module is imported already
        old_argv, sys.argv = sys.argv, [module, *argv]
        stack.callback(setattr, sys, "argv", old_argv)
        try:
            if path is None:
                runpy.run_module(module, run_name="__main__")
            else:
                runpy.run_path(str(path), run_name="__main__")
        except SystemExit as e:  # --eval exits 0
            assert e.code in (0, None), e.code
    return capsys.readouterr().out


def _port_cli(main, argv: list, capsys) -> str:
    capsys.readouterr()
    assert main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out


def _losses(out: str) -> list:
    return [float(v) for v in re.findall(r"loss (\d+\.\d+)", out)]


def _params_close(model: torch.nn.Module, params) -> None:
    want = el.params_from_flax(jax.device_get(params))
    diffs = np.concatenate([(p.detach() - want[n]).abs().flatten().numpy() for n, p in model.named_parameters()])
    assert float((diffs <= 1e-6).mean()) >= 0.999 and diffs.max() <= 6 * LR, (
        float((diffs <= 1e-6).mean()), diffs.max())


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("module, port_main", [("nu_scaler_tpu.models.interp_refine", pir.main),
                                               ("nu_scaler_tpu.models.train", ptrain.main)],
                         ids=["interp_refine", "train"])
def test_flags_and_defaults_are_jaxs(module, port_main, monkeypatch):
    """Both command lines parse no arguments into JAX's flags and defaults,
    with --device (the card unless cpu) in place of --cpu."""
    seen = []
    parse = argparse.ArgumentParser.parse_args

    def record(self, args=None, namespace=None):
        seen.append(vars(parse(self, args, namespace)))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    monkeypatch.setattr(sys, "argv", [module])
    with warnings.catch_warnings(), pytest.raises(_Parsed):
        warnings.simplefilter("ignore", RuntimeWarning)
        runpy.run_module(module, run_name="__main__")
    with pytest.raises(_Parsed):
        port_main([])
    jax_args, port_args = seen
    assert jax_args.pop("cpu") is False and port_args.pop("device") is None
    assert port_args == jax_args


def test_training_leg_matches_jax(roots, mean_mids, capsys):
    """A 2-step leg of interp_ref4 at 128x256: both resume from 112000, print
    their losses and save 112002 within the training tests' bounds."""
    jroot, proot = roots
    _copy_orbax("interp_ref4", jroot)
    jout = _jax_cli("nu_scaler_tpu.models.interp_refine", ["--steps", "2", *LEG, "--cpu"], capsys)
    pout = _port_cli(pir.main, ["--steps", "2", *LEG], capsys)
    for out in (jout, pout):
        assert "resumed interp_ref4 from step 112000" in out and "rendering triplet pool" in out
    jl, pl = _losses(jout), _losses(pout)
    assert len(jl) == len(pl) == 2 and np.isfinite(pl).all()
    assert all(abs(a - b) <= 1e-5 for a, b in zip(jl, pl)), (jl, pl)
    params, jstep = jir.load_checkpoint()
    model, step = pir.load_checkpoint()
    assert jstep == step == 112002 and f"checkpoint: {proot / 'interp_ref4' / 'interp_ref4_112002.npz'}" in pout
    _params_close(model, params)


def test_distill_leg_into_a_named_student(roots, mean_mids, capsys):
    """--distill-name interp_ref4w into a named 16/1 student (both sides
    resume its shared step 0): the teacher resolves at 32000, the losses and
    the saved step 2 agree, and neither package writes interp_ref4."""
    jroot, proot = roots
    _copy_orbax("interp_ref4w", jroot)
    student = pir.make_model(16, 1, seed=3)
    pir.save_checkpoint(student, 0, "t_student")
    jir.save_checkpoint({"params": _nest(el.flax_arrays(student))}, 0, name="t_student")
    argv = ["--name", "t_student", "--features", "16", "--blocks", "1", "--distill-name", "interp_ref4w",
            "--steps", "2", *LEG]
    jout = _jax_cli("nu_scaler_tpu.models.interp_refine", [*argv, "--cpu"], capsys)
    pout = _port_cli(pir.main, argv, capsys)
    for out in (jout, pout):
        assert "resumed t_student from step 0" in out and "distilling from interp_ref4w@32000 (w=0.5)" in out
    jl, pl = _losses(jout), _losses(pout)
    assert len(jl) == len(pl) == 2 and all(abs(a - b) <= 1e-5 for a, b in zip(jl, pl)), (jl, pl)
    params, jstep = jir.load_checkpoint("t_student")
    model, step = pir.load_checkpoint("t_student")
    assert jstep == step == 2 and (model.features, model.blocks) == (16, 1)
    _params_close(model, params)
    assert not (jroot / "interp_ref4").exists() and not (proot / "interp_ref4").exists()


@pytest.mark.parametrize("extra", [[], ["--no-head", "--name", "interp_ref4w"]], ids=["head", "no_head_named"])
def test_calibrate_the_committed_step(roots, capsys, extra):
    """--calibrate on the port's empty root copies the committed 112000 into
    it and writes JAX's scales there (whatever --name says: the serving
    net); the API then serves 112000 in int8 from that copy, as JAX serves
    its calibrated step, the same refined mid."""
    jroot, proot = roots
    _copy_orbax("interp_ref4", jroot)
    argv = ["--calibrate", "--clips", "1", "--height", "128", "--width", "256", *extra]
    with _mean_mids():
        jout = _jax_cli("nu_scaler_tpu.models.interp_refine", [*argv, "--cpu"], capsys)
        pout = _port_cli(pir.main, argv, capsys)
    want = json.loads((jroot / "interp_ref4" / "act_scales.json").read_text())
    sidecar = proot / "interp_ref4" / "interp_ref4_112000.json"
    assert f"saved {jroot / 'interp_ref4' / 'act_scales.json'}: " in jout and f"saved {sidecar}: " in pout
    assert sorted(p.name for p in proot.rglob("*")) == ["interp_ref4", "interp_ref4_112000.json",
                                                        "interp_ref4_112000.npz"]
    meta = json.loads(sidecar.read_text())
    got = el.sidecar_scales(meta)
    assert want["step"] == meta["step"] == 112000 and list(got) == list(want["scales"])
    assert ("head" in got) == (not extra)
    print("scales, max relative |d|:", max(_rel(got[k], v) for k, v in want["scales"].items()))
    for k, v in want["scales"].items():
        assert _rel(got[k], v) <= 1e-5, (k, got[k], v)
    committed = json.loads((el.WEIGHTS_DIR / "interp_ref4_112000.json").read_text())
    assert {k: v for k, v in meta.items() if k != "act_scales"} == committed

    # the API serves the copy in int8; JAX serves its calibrated step
    _clear_caches()
    assert pir._newest()[1] == proot / "interp_ref4" and pir.load_model()[1]["step"] == 112000
    graph = pir.get_refine_graph(16, 128, "cpu")
    assert graph.quantized and graph.quant_scales == got
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (16, 128, 4), np.uint8)
    b = np.roll(a, 3, axis=1)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    soft = P.make_interpolator(16, 128, "flow_soft", "cpu")(at, bt, 0.5)
    mid = P.make_interpolator(16, 128, "flow_soft_ref", "cpu")(at, bt, 0.5)
    assert torch.equal(mid, graph(at, bt, soft))
    # JAX's graph op by op: jitted, XLA keeps _conv_i8's bf16 casts in fp32
    # inside its fusions (tests/test_torch_interp_refine.py)
    jmid = np.asarray(jir.get_refine_graph(16, 128)(*(jnp.asarray(x) for x in (a, b, soft.numpy()))))
    print(f"int8 refined mid vs JAX's: {psnr(mid.numpy(), jmid):.2f} dB")
    np.testing.assert_array_equal(mid.numpy()[..., 3], jmid[..., 3])
    assert psnr(mid.numpy(), jmid) >= 50.0


def test_calibrate_io_of_the_committed_sr_step(roots, tmp_path, monkeypatch, capsys):
    """`train --arch tpu4b2 --calibrate --io` on the port's empty root copies
    the committed 76000 (npz, sidecar, Adam moments) and writes JAX's scales
    there; the "quality" ladder serves it in int8 from the copy, with those
    scales; a later leg resumes from the copy exactly as from the export."""
    jroot, proot = roots
    _copy_orbax("esrgan_tpu4b2_x2", jroot)
    copy = tmp_path / "nu_scaler_tpu" / "models" / "train.py"  # its CKPT_ROOT: tmp_path/checkpoints
    copy.parent.mkdir(parents=True)
    shutil.copyfile(jtrain.__file__, copy)
    argv = ["--arch", "tpu4b2", "--calibrate", "--io"]
    jout = _jax_cli("nu_scaler_tpu.models.train", [*argv, "--cpu"], capsys, path=copy)
    pout = _port_cli(ptrain.main, argv, capsys)
    stem = "esrgan_tpu4b2_x2_76000"
    assert f"tpu4b2@76000 int8 scales → {jroot / 'esrgan_tpu4b2_x2' / 'act_scales.json'}" in jout
    assert f"tpu4b2 int8 scales -> {proot / (stem + '.json')}" in pout
    assert sorted(p.name for p in proot.iterdir()) == [f"{stem}.json", f"{stem}.npz", f"{stem}_opt.npz"]
    want = json.loads((jroot / "esrgan_tpu4b2_x2" / "act_scales.json").read_text())
    got = el.load_act_scales("tpu4b2", 2, proot)
    assert want["step"] == 76000 and list(got) == list(want["scales"])
    assert got["head"] == got["base"] == 1.0
    for k, v in want["scales"].items():
        assert _rel(got[k], v) <= 1e-5, (k, got[k], v)

    _clear_caches()
    port = el.make_pretrained_upscaler(32, 64, 64, 128, device="cpu")
    assert (port.arch, port.step, port.quantized, port.directory) == ("tpu4b2", 76000, True, proot)
    assert port.serving.quant_scales == got

    # a leg from the copy (its moments) equals a leg from the export
    legs = {}
    for root in (proot, tmp_path / "export"):
        monkeypatch.setattr(ptrain, "CKPT_ROOT", root)
        ptrain.train(steps=1, batch=2, arch="tpu4b2", data="synthetic", device="cpu")
        assert "restored optimizer state (the committed export's)" in capsys.readouterr().out
        legs[root] = ptrain.load_checkpoint("tpu4b2", 1)
    (a, sa), (b, sb) = legs.values()
    assert sa == sb == 76001 and all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("net, broken", [("tpu4b2", "npz"), ("tpu4b2", "opt"), ("interp_ref4", "npz")])
def test_corrupt_export_writes_nothing(roots, tmp_path, monkeypatch, net, broken):
    """An export whose npz (or Adam moments) is not its sidecar's sha256:
    --calibrate raises and writes nothing into CKPT_ROOT."""
    _, proot = roots
    stem = "esrgan_tpu4b2_x2_76000" if net == "tpu4b2" else "interp_ref4_112000"
    weights = tmp_path / "weights"
    weights.mkdir()
    for p in el.WEIGHTS_DIR.glob(f"{stem}*"):
        shutil.copyfile(p, weights / p.name)
    target = weights / (f"{stem}_opt.npz" if broken == "opt" else f"{stem}.npz")
    raw = bytearray(target.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    target.write_bytes(bytes(raw))
    monkeypatch.setattr(el, "WEIGHTS_DIR", weights)
    monkeypatch.setattr(pir, "WEIGHTS_DIR", weights)
    if broken == "opt":  # the weights load; the copy checks the moments before writing
        monkeypatch.setattr(el, "default_trunk_scales", lambda model: {"tail": 1.0})
    with pytest.raises(ValueError, match="sha256"):
        if net == "tpu4b2":
            ptrain.main(["--arch", "tpu4b2", "--calibrate", "--io", "--device", "cpu"])
        else:
            pir.main(["--calibrate", "--device", "cpu"])
    assert not proot.exists() or not any(proot.rglob("*"))


def test_calibrate_without_weights_exits(roots, monkeypatch):
    monkeypatch.setattr(pir, "WEIGHTS_DIR", roots[1] / "none")
    with pytest.raises(SystemExit, match="no interp_ref4 checkpoint"):
        pir.main(["--calibrate", "--device", "cpu"])
    monkeypatch.setattr(el, "WEIGHTS_DIR", roots[1] / "none")
    with pytest.raises(FileNotFoundError, match="no checkpoint of tpu4b2 x2"):
        ptrain.main(["--arch", "tpu4b2", "--calibrate", "--device", "cpu"])


_EVAL = re.compile(r"(\w+)@(\d+): (-?[\d.]+) dB / (-?[\d.]+) SSIM vs soft (-?[\d.]+) / (-?[\d.]+)")


def test_eval_matches_jax(roots, capsys):
    """--eval of the committed 112000 at 64x256 with JAX's protocol (seeds
    900-902, 5 frames each): the printed line's PSNRs and SSIMs within
    EVAL_GATE."""
    jroot, _ = roots
    _copy_orbax("interp_ref4", jroot)
    argv = ["--eval", "--height", "64", "--width", "256"]
    jout = _jax_cli("nu_scaler_tpu.models.interp_refine", [*argv, "--cpu"], capsys)
    pout = _port_cli(pir.main, argv, capsys)
    want, got = _EVAL.search(jout).groups(), _EVAL.search(pout).groups()
    print(jout, pout)
    assert want[:2] == got[:2] == ("interp_ref4", "112000")
    for i, (w, g) in enumerate(zip(want[2:], got[2:])):
        assert abs(float(w) - float(g)) <= EVAL_GATE[i % 2], (jout, pout)


def test_eval_refine_float_matches_jax(roots):
    """`eval_refine_float` of the committed 112000 at 64x256, one seed of 3
    frames: soft and refined PSNR within 0.05 dB, SSIM within 1e-3."""
    jroot, _ = roots
    _copy_orbax("interp_ref4", jroot)
    kw = dict(seeds=(900,), frames=3, height=64, width=256)
    want = jir.eval_refine_float(**kw)
    got = pir.eval_refine_float(**kw, device="cpu")
    assert got["step"] == want["step"] == 112000
    print({k: got[k] - want[k] for k in want if k not in ("name", "step")})
    for k in ("soft_psnr_db", "ref_psnr_db", "psnr_delta_db"):
        assert abs(got[k] - want[k]) <= EVAL_GATE[0], (k, got[k], want[k])
    for k in ("soft_ssim", "ref_ssim", "ssim_delta"):
        assert abs(got[k] - want[k]) <= EVAL_GATE[1], (k, got[k], want[k])
