"""The checkpoints the port carries and the ones its trainers write, against
the JAX package reading the same checkpoints, on the CPU.

JAX serves, resumes from and distills from the step its ``latest.txt``
names under its `CKPT_ROOT` (`nu_scaler_tpu/models/train.py:50-60`,
`interp_refine.py:80-99`). The port reads the newest step in its trainer's
`CKPT_ROOT`, else its committed export (`esrgan_lite.weights_directory`,
`interp_refine._newest`). Every test here builds both roots under
`tmp_path`: JAX's (`train.CKPT_ROOT`, `interp_refine.CKPT_ROOT` and
`interp_refine.CKPT_DIR`, which that module binds at import) holds copies of
the committed orbax checkpoints the test needs; the port's starts empty.
Both sides then save the same new step, and the two packages must pick the
same arch and step and compute the same thing.

Bounds are the existing files':

* an export against its orbax tree: bit for bit, key for key;
* the served bytes against JAX's jitted ladder
  (`tests/test_torch_esrgan_ladder.py`): ≥ 45 dB RGB, mean |d| < 1 LSB,
  alpha equal (α ≡ 255); an int8 graph bit-equal to JAX's run op by op
  (`tests/test_torch_int8.py`);
* one training step (`tests/test_torch_train.py`): the loss within a
  relative 1e-5, the parameters 99.9% within 1e-6 and all within 6·lr;
* teacher outputs: max |Δ| ≤ 1e-5 (a checkpoint through JAX's
  `model.apply` against the port's module, `tests/test_torch_train.py`);
* the refined mid (`tests/test_torch_interp_refine.py`): ≥ 50 dB RGB,
  alpha equal.
"""

import hashlib
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from nu_scaler_tpu.models import esrgan_lite as jel
from nu_scaler_tpu.models import interp_refine as jir
from nu_scaler_tpu.models import train as jtrain
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch.core import technologies as tech
from nu_scaler_tpu_torch.models import esrgan_lite as el
from nu_scaler_tpu_torch.models import interp_refine as pir
from nu_scaler_tpu_torch.models import train as ptrain
from nu_scaler_tpu_torch.ops import interpolate as P

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = el.WEIGHTS_DIR
LR = 2e-4
# the exports of every orbax checkpoint the JAX package reads that the
# ladders' first rungs do not: (committed stem, orbax dir, step, kwargs)
EXPORTS = [
    ("esrgan_tpu4_x2_80000", "esrgan_tpu4_x2", 80000, dict(stride=4, features=128, blocks=3)),
    ("esrgan_tpu8_x2_40000", "esrgan_tpu8_x2", 40000, dict(stride=8, features=128, blocks=3)),
    ("esrgan_tpu8w_x2_60000", "esrgan_tpu8w_x2", 60000, dict(stride=8, features=192, blocks=3)),
    ("interp_ref4w_32000", "interp_ref4w", 32000, dict(features=192, blocks=2, stride=4)),
]
PORT_CACHES = (el._cached_model, el._build_pretrained, pir.load_model, pir._refine_graph, P._interpolator,
               P._multi_interpolator, P._refined_mid_upscaler, P._refined_multi_upscaler)
JAX_CACHES = (jel.make_pretrained_upscaler, jel.make_fast_upscaler, jir.get_refine_graph,
              jir.get_refine_phase_graph, jir._make_refine_fn)


def _clear_caches() -> None:
    for fn in PORT_CACHES + JAX_CACHES:
        fn.cache_clear()


def _listing() -> list:
    dirs = (ROOT / "checkpoints", WEIGHTS, ROOT / "checkpoints_torch")
    return [sorted((p.relative_to(d).as_posix(), p.stat().st_mtime_ns) for p in d.rglob("*"))
            if d.exists() else None for d in dirs]


def _copy_orbax(name: str, root: Path) -> None:
    """Copy the committed orbax checkpoint `name` (its latest.txt, the step
    it names, that step's Adam state and act_scales.json where present)
    into `root`."""
    src, dst = ROOT / "checkpoints" / name, root / name
    step = (src / "latest.txt").read_text().strip()
    dst.mkdir(parents=True)
    for part in ("latest.txt", "act_scales.json", step, f"{step}_opt"):
        if (src / part).is_dir():
            shutil.copytree(src / part, dst / part)
        elif (src / part).exists():
            shutil.copy2(src / part, dst / part)


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """(JAX's CKPT_ROOT, the port's), empty, under tmp_path; the loaders'
    caches cleared before and after; nothing written elsewhere."""
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jroot.mkdir()
    monkeypatch.setattr(jtrain, "CKPT_ROOT", str(jroot))
    monkeypatch.setattr(jir, "CKPT_ROOT", str(jroot))
    monkeypatch.setattr(jir, "CKPT_DIR", str(jroot / "interp_ref4"))
    monkeypatch.setattr(ptrain, "CKPT_ROOT", proot)
    before = _listing()
    _clear_caches()
    yield jroot, proot
    _clear_caches()
    assert _listing() == before


def _flat(tree, prefix: str = "") -> dict:
    if "params" in tree and not prefix:
        tree = tree["params"]
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _perturbed(tree: dict, seed: int) -> dict:
    """A new step: every array of `tree` moved by 1% of its spread."""
    rng = np.random.default_rng(seed)
    return _nest({k: (v + np.float32(0.01 * v.std()) * rng.standard_normal(v.shape)).astype(np.float32)
                  for k, v in _flat(tree).items()})


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _params_close(model: torch.nn.Module, params) -> None:
    want = el.params_from_flax(jax.device_get(params))
    diffs = np.concatenate([(p.detach() - want[n]).abs().flatten().numpy() for n, p in model.named_parameters()])
    assert float((diffs <= 1e-6).mean()) >= 0.999 and diffs.max() <= 6 * LR, (
        float((diffs <= 1e-6).mean()), diffs.max())


def _rgb_psnr(a: np.ndarray, b: np.ndarray) -> float:
    d = a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# ---------------------------------------------------------------------------
# the exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stem, orbax_dir, step, kwargs", EXPORTS, ids=[e[0] for e in EXPORTS])
def test_export_equals_its_orbax_tree(stem, orbax_dir, step, kwargs):
    """The npz equals the orbax restore at the step latest.txt names, array
    for array; its sha256 is its sidecar's; the sidecar's kwargs are the
    tree's shapes; the loaders read it (checking the sha256)."""
    src = ROOT / "checkpoints" / orbax_dir
    assert int((src / "latest.txt").read_text()) == step
    want = _flat(ocp.PyTreeCheckpointer().restore(str(src / str(step))))
    npz = el.WEIGHTS_DIR / f"{stem}.npz"
    meta = json.loads((el.WEIGHTS_DIR / f"{stem}.json").read_text())
    assert meta["step"] == step and meta["model"] == kwargs
    assert hashlib.sha256(npz.read_bytes()).hexdigest() == meta["sha256"]
    with np.load(npz) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == np.float32 and np.array_equal(z[k].view(np.uint32), v.astype(np.float32).view(
                np.uint32)), k
    f = kwargs["features"]
    assert want["block0/conv1/kernel"].shape == (3, 3, f, f) and f"block{kwargs['blocks'] - 1}/conv2/bias" in want
    assert f"block{kwargs['blocks']}/conv1/bias" not in want
    if orbax_dir.startswith("esrgan_"):
        arch = orbax_dir.split("_")[1]
        assert want["head/kernel"].shape[2] == 3 * kwargs["stride"] ** 2
        model, got = el.load_model(arch, 2)
        assert got["step"] == step and (model.stride, model.features, model.blocks) == tuple(
            kwargs[k] for k in ("stride", "features", "blocks"))
        assert model.base_impl == ("sparse" if kwargs["stride"] == 8 else "conv")
        # JAX carries int8 scales for tpu4 x2 only, at its step
        assert el.sidecar_scales(got) == jtrain.load_act_scales(1, arch, step)
    else:
        assert want["head/kernel"].shape[2] == 9 * kwargs["stride"] ** 2
        model, got = pir.load_checkpoint(orbax_dir)
        assert got == step and (model.features, model.blocks) == (kwargs["features"], kwargs["blocks"])


def test_tpu4_x2_moments_equal_orbax():
    """The export's Adam state equals the orbax ``80000_opt`` tree (count,
    mu, nu) and its sha256 is the sidecar's ``opt_sha256``."""
    src = ROOT / "checkpoints" / "esrgan_tpu4_x2" / "80000_opt"
    adam = ocp.PyTreeCheckpointer().restore(str(src))[0]
    npz = el.WEIGHTS_DIR / "esrgan_tpu4_x2_80000_opt.npz"
    meta = json.loads((el.WEIGHTS_DIR / "esrgan_tpu4_x2_80000.json").read_text())
    assert hashlib.sha256(npz.read_bytes()).hexdigest() == meta["opt_sha256"]
    with np.load(npz) as z:
        assert z["count"].dtype == np.int32 and int(z["count"]) == int(adam["count"])
        for moment in ("mu", "nu"):
            for k, v in _flat(adam[moment]).items():
                assert np.array_equal(z[f"{moment}/{k}"], v.astype(np.float32)), (moment, k)


# ---------------------------------------------------------------------------
# serving what the trainer wrote
# ---------------------------------------------------------------------------

# after a new tpu4b2 x2 step without calibration: (arch, step, quantized,
# served from the port's CKPT_ROOT)
PICKS = {"ultra": ("tpu4b2", 76001, False, True), "quality": ("tpu4", 80000, True, False),
         "performance": ("tpu4b1", 40000, True, False)}


@pytest.mark.parametrize("prefer", sorted(PICKS))
def test_ladders_serve_what_jax_serves(roots, prefer):
    """The same new tpu4b2 x2 step (76001, no calibration) saved by both
    trainers' checkpoint writers: "ultra" serves it in bf16, "quality"
    falls to tpu4 x2 int8 at 80000 (the tpu4b2 int8 entry has no scales at
    76001), "performance" keeps tpu4b1 at 40000; JAX's ladder picks the
    same, and the bytes at 32×64 → 64×128 meet the ladder's bound (int8:
    bit-equal to JAX run op by op)."""
    jroot, proot = roots
    for name in ("esrgan_tpu4b2_x2", "esrgan_tpu4_x2", "esrgan_tpu4b1_x2"):
        _copy_orbax(name, jroot)
    tree = _perturbed(el.load_weights("tpu4b2", 2)[0], seed=21)
    jtrain.save_checkpoint({"params": tree}, 1, 76001, "tpu4b2")
    model = ptrain.make_model("tpu4b2", 1)
    model.load_state_dict(el.params_from_flax(tree))
    ptrain.save_checkpoint(model, "tpu4b2", 1, 76001)

    arch, step, quantized, own = PICKS[prefer]
    jfn = jel.make_pretrained_upscaler(32, 64, 64, 128, prefer=prefer)
    port = el.make_pretrained_upscaler(32, 64, 64, 128, prefer=prefer, device="cpu")
    assert (jfn.arch, jtrain.load_checkpoint(1, jfn.arch)[1], jfn.quantized) == (arch, step, quantized)
    assert (port.arch, port.step, port.quantized) == (arch, step, quantized)
    assert port.directory == (proot if own else el.WEIGHTS_DIR)
    img = np.random.default_rng(32).integers(0, 256, (32, 64, 4), np.uint8)
    img[..., 3] = 255
    got = port(img).numpy()
    want = np.asarray(jfn(jnp.asarray(img)))
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"{prefer}: {arch}@{step} {_rgb_psnr(got, want):.2f} dB, mean {d[..., :3].mean():.3f}, max {d.max()}")
    assert got.shape == want.shape == (64, 128, 4)
    assert _rgb_psnr(got, want) >= 45.0 and d[..., :3].mean() < 1.0 and d[..., 3].max() == 0
    if quantized:
        with jax.disable_jit():
            np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(img))))


def test_learned_tier_reads_the_trainers_root(roots, monkeypatch):
    """Without committed weights, a tpu4b1 x2 checkpoint in CKPT_ROOT makes
    the "performance" ladder (and its technology, "xess") available and
    serves, and "quality" ("dlss") stays unavailable."""
    _, proot = roots
    model, _ = ptrain.load_checkpoint("tpu4b1", 1, el.WEIGHTS_DIR)
    monkeypatch.setattr(el, "WEIGHTS_DIR", el.WEIGHTS_DIR / "missing")
    assert not el.learned_tier_available("performance")
    ptrain.save_checkpoint(model, "tpu4b1", 1, 7)
    assert el.learned_tier_available("performance") and not el.learned_tier_available("quality")
    assert tech.is_supported("xess", "cpu") and not tech.is_supported("dlss", "cpu")
    up = el.make_pretrained_upscaler(32, 64, 64, 128, prefer="performance", device="cpu")
    assert (up.arch, up.step, up.quantized, up.directory) == ("tpu4b1", 7, False, proot)


def test_saved_interp_ref4_step_serves(roots):
    """A new interp_ref4 step saved by both packages' writers is what the
    port's `refine_available` / `load_model` and the "flow_soft_ref" mid
    serve (caches cleared), and JAX's `refine_mid` serves the same mid."""
    jroot, proot = roots
    committed = pir.load_model()[0]
    tree, meta = pir.load_weights()
    assert meta["step"] == 112000
    tree = _perturbed(tree, seed=22)
    jir.save_checkpoint({"params": tree}, 112001)
    model = pir.InterpRefine(**meta["model"])
    model.load_state_dict(el.params_from_flax(tree))
    pir.save_checkpoint(model, 112001)
    _clear_caches()
    assert pir.refine_available() and pir.load_act_scales() is None
    assert pir.load_model()[1]["step"] == 112001 and pir.get_refine_graph(16, 128, "cpu").quantized is False

    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (16, 128, 4), np.uint8)
    b = np.roll(a, 3, axis=1)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    mid = P.make_interpolator(16, 128, "flow_soft_ref", "cpu")(at, bt, 0.5)
    soft = P.make_interpolator(16, 128, "flow_soft", "cpu")(at, bt, 0.5)
    assert torch.equal(mid, pir.RefineGraph(model, 16, 128, "cpu")(at, bt, soft))
    assert not torch.equal(mid, pir.RefineGraph(committed, 16, 128, "cpu")(at, bt, soft))
    want = np.asarray(jir.refine_mid(jnp.asarray(a), jnp.asarray(b), jnp.asarray(soft.numpy())))
    got = mid.numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    assert psnr(got, want) >= 50.0


@pytest.mark.parametrize("net", ["tpu4b2", "interp_ref4"])
def test_corrupt_checkpoint_raises(roots, net):
    """A CKPT_ROOT checkpoint whose npz is not its sidecar's sha256 raises
    in every loader; it never gives way to the committed export."""
    _, proot = roots
    if net == "tpu4b2":
        npz = ptrain.save_checkpoint(ptrain.load_checkpoint("tpu4b2", 1, el.WEIGHTS_DIR)[0], "tpu4b2", 1, 76001)
    else:
        npz = pir.save_checkpoint(pir.load_checkpoint()[0], 112001)
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    npz.write_bytes(bytes(raw))
    _clear_caches()
    with pytest.raises(ValueError, match="sha256"):
        if net == "tpu4b2":
            el.make_pretrained_upscaler(32, 64, 64, 128, prefer="ultra", device="cpu")
        else:
            pir.get_refine_graph(16, 128, "cpu")
    with pytest.raises(ValueError, match="sha256"):
        ptrain.load_latest("tpu4b2", 1) if net == "tpu4b2" else pir.load_checkpoint()


# ---------------------------------------------------------------------------
# resume and distillation
# ---------------------------------------------------------------------------


def test_tpu4_x2_resumes_from_80000_as_jax(roots, capsys):
    """`train --arch tpu4` at x2, one synthetic step: JAX resumes from its
    orbax 80000 with its Adam state, the port from the export with its
    moments; the losses and the saved 80001 agree."""
    jroot, proot = roots
    _copy_orbax("esrgan_tpu4_x2", jroot)
    kw = dict(steps=1, batch=2, stages=1, arch="tpu4", data="synthetic", log_every=1)
    jloss = jtrain.train(**kw)
    out = capsys.readouterr().out
    assert "resumed from step 80000" in out and "restored optimizer state" in out
    ploss = ptrain.train(**kw, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 80000 (the committed export)" in out
    assert "restored optimizer state (the committed export's)" in out
    assert _rel(ploss, jloss) <= 1e-5, (ploss, jloss)
    params, jstep = jtrain.load_checkpoint(1, "tpu4")
    model, step = ptrain.load_checkpoint("tpu4", 1)
    assert jstep == step == 80001
    _params_close(model, params)


def test_tpu4_teacher_resolves_as_jax(roots, capsys):
    """`teacher_outputs("tpu4", 1, …)` (`train --distill tpu4` at x2)
    distills from tpu4 x2 at 80000 in both packages, with the same
    outputs."""
    jroot, _ = roots
    _copy_orbax("esrgan_tpu4_x2", jroot)
    lrs = np.random.default_rng(4).random((3, 24, 24, 3), dtype=np.float32)
    want = jtrain.teacher_outputs("tpu4", 1, lrs)
    got = ptrain.teacher_outputs("tpu4", 1, lrs, "cpu")
    assert capsys.readouterr().out.count("distilling from tpu4@80000") == 2
    assert got.shape == want.shape == (3, 48, 48, 3)
    assert float(np.abs(got - want).max()) <= 1e-5


class _StubPool:
    """Seeded random crops in place of the rendered `TripletPool`, drawn
    from the trainer's generator as the pool draws its crops."""

    def __init__(self, rng, **kw):
        crop, n = kw["crop"], kw["pool_size"]
        self.xs = rng.random((n, crop, crop, 9), dtype=np.float32)
        self.ys = np.clip(self.xs[..., 6:9] + 0.05 * rng.standard_normal((n, crop, crop, 3)), 0, 1).astype(
            np.float32)


def test_interp_ref4w_distill_step_matches_jax(roots, monkeypatch, capsys):
    """`train(distill=("interp_ref4w", 192, 2))` of interp_ref4, one step:
    both packages resume from 112000 and resolve the teacher at 32000; the
    losses and the saved 112001 agree."""
    jroot, _ = roots
    for name in ("interp_ref4", "interp_ref4w"):
        _copy_orbax(name, jroot)
    monkeypatch.setattr(jir, "TripletPool", _StubPool)
    monkeypatch.setattr(pir, "TripletPool", _StubPool)
    kw = dict(steps=1, batch=2, crop=16, pool_size=8, n_clips=1, log_every=1, distill=("interp_ref4w", 192, 2))
    jloss = jir.train(**kw)
    ploss = pir.train(**kw, device="cpu")
    out = capsys.readouterr().out
    assert out.count("resumed interp_ref4 from step 112000") == 2
    assert out.count("distilling from interp_ref4w@32000") == 2
    assert _rel(ploss, jloss) <= 1e-5, (ploss, jloss)
    params, jstep = jir.load_checkpoint()
    model, step = pir.load_checkpoint()
    assert jstep == step == 112001
    _params_close(model, params)
