"""The port's training of the learned tier (`nu_scaler_tpu_torch/models/train.py`
and the training half of `models/esrgan_lite.py`) against the JAX package's
(`nu_scaler_tpu/models/train.py`, `esrgan_lite.py:344-389,746-803`), on the
CPU, on the same seeded numpy inputs, the JAX parameters carried across by
`params_from_flax`.

Tolerances (fp32 sums in another order on each side):

* the L1 and L1 + gradient losses: relative |Δ| ≤ 1e-5;
* the gradients, per tensor: max |Δ| ≤ 1e-4 · max |g_jax|;
* three Adam steps against `optax.adam`: 99.9% of the parameters within
  1e-6 and all within 6·lr (Adam normalises a near-zero gradient to about
  ±lr, so a rounding can flip its sign: at most 2·lr a step), the loss after
  them within a relative 1e-4. These cases hold tighter: 99.99% within 1e-6
  and all within lr/20 (measured: at most 1.74e-6, 0.0022% of the elements
  past 1e-6, on the stride-4 net);
* the int8 calibration: relative 1e-5;
* a checkpoint's npz through JAX's `model.apply` against the port's module:
  max |Δ| ≤ 1e-5.

Every test writes only under `tmp_path` (the port's `CKPT_ROOT` patched).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nu_scaler_tpu.models import esrgan_lite as jel
from nu_scaler_tpu.models import train as jtrain
from nu_scaler_tpu_torch.models import esrgan_lite as el
from nu_scaler_tpu_torch.models import interp_refine as pir
from nu_scaler_tpu_torch.models import train as ptrain

LR = 2e-4
# (tag, the JAX module, the port's module, the LR side): the stride-2 and
# stride-4 s2d nets (16 features, 2 blocks) and ESRGANLite (8 features, 1 block)
MODELS = {
    "tpu_s2": (lambda: jel.ESRGANLiteTPU(upscale=2, stride=2, features=16, blocks=2),
               lambda: el.ESRGANLiteTPU(features=16, blocks=2, upscale=2, stride=2), 16),
    "tpu_s4": (lambda: jel.ESRGANLiteTPU(upscale=2, stride=4, features=16, blocks=2),
               lambda: el.ESRGANLiteTPU(features=16, blocks=2, upscale=2, stride=4), 16),
    "lite": (lambda: jel.ESRGANLite(features=8, blocks=1, stages=1),
             lambda: el.ESRGANLite(features=8, blocks=1, stages=1), 16),
}
JAX_LOSSES = {"l1": jel.l1_loss, "l1_grad": jel.l1_grad_loss}
PORT_LOSSES = {"l1": el.l1_loss, "l1_grad": el.l1_grad_loss}


def _case(tag: str, seed: int = 5):
    """(JAX module, JAX params, the port's module with them, lr, hr): lr
    [2, s, s, 3] and hr [2, 2s, 2s, 3] in [0, 1] from a seeded generator."""
    jmake, pmake, s = MODELS[tag]
    jm = jmake()
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3), jnp.float32))
    pm = pmake()
    pm.load_state_dict(el.params_from_flax(params))
    rng = np.random.default_rng(seed)
    hr = rng.random((2, 2 * s, 2 * s, 3), dtype=np.float32)
    lr = hr.reshape(2, s, 2, s, 2, 3).mean(axis=(2, 4))
    return jm, params, pm, lr, hr


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("loss", ["l1", "l1_grad"])
@pytest.mark.parametrize("tag", sorted(MODELS))
def test_loss_and_gradients_match_jax(tag, loss):
    jm, params, pm, lr, hr = _case(tag)
    jfn = JAX_LOSSES[loss]
    lv, grads = jax.jit(jax.value_and_grad(lambda p: jfn(jm, p, jnp.asarray(lr), jnp.asarray(hr))))(params)
    el.adam(pm, LR)  # trainable
    with el.fp32_training():
        plv = PORT_LOSSES[loss](pm, _t(lr), _t(hr))
        plv.backward()
    assert _rel(float(plv.detach()), float(lv)) <= 1e-5, (float(plv.detach()), float(lv))
    want = el.params_from_flax(jax.device_get(grads))
    got = dict(pm.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        d = float((got[name].grad - g).abs().max())
        assert d <= 1e-4 * float(g.abs().max()), (name, d, float(g.abs().max()))


def _adam_close(pm, params, what: str) -> None:
    want = el.params_from_flax(jax.device_get(params))
    diffs = np.concatenate([(p.detach() - want[n]).abs().flatten().numpy() for n, p in pm.named_parameters()])
    within = float((diffs <= 1e-6).mean())
    print(f"{what}: {within:.6f} of {diffs.size} within 1e-6, max {diffs.max():.3g} (lr {LR})")
    assert within >= 0.999 and diffs.max() <= 6 * LR
    assert within >= 0.9999 and diffs.max() <= LR / 20  # the tighter bound these cases hold


@pytest.mark.parametrize("loss", ["l1", "l1_grad"])
@pytest.mark.parametrize("tag", sorted(MODELS))
def test_three_adam_steps_match_optax(tag, loss):
    jm, params, pm, lr, hr = _case(tag)
    opt = optax.adam(LR)
    jstep = jel.make_train_step(jm, opt, loss)
    state = opt.init(params)
    popt = el.adam(pm, LR)
    pstep = el.make_train_step(pm, popt, loss)
    lj, hj = jnp.asarray(lr), jnp.asarray(hr)
    for _ in range(3):
        params, state, jl = jstep(params, state, lj, hj)
        pm_, popt_, pl = pstep(_t(lr), _t(hr))
        assert pm_ is pm and popt_ is popt
        assert _rel(float(pl), float(jl)) <= 1e-5
    _adam_close(pm, params, f"{tag} {loss}")
    after_j = float(JAX_LOSSES[loss](jm, params, lj, hj))
    with torch.no_grad(), el.fp32_training():
        after_p = float(PORT_LOSSES[loss](pm, _t(lr), _t(hr)))
    assert _rel(after_p, after_j) <= 1e-4, (after_p, after_j)


@pytest.mark.parametrize("tag", ["tpu_s4", "lite"])
def test_distill_step_matches_jax(tag):
    """The two-term distillation step, loss and three Adam steps, against
    JAX's `make_distill_step`."""
    jm, params, pm, lr, hr = _case(tag)
    teach = np.clip(hr + 0.25, 0.0, 1.0).astype(np.float32)
    opt = optax.adam(LR)
    jstep = jtrain.make_distill_step(jm, opt, "l1_grad", 0.3)
    state = opt.init(params)
    pstep = ptrain.make_distill_step(pm, el.adam(pm, LR), "l1_grad", 0.3)
    for _ in range(3):
        params, state, jl = jstep(params, state, jnp.asarray(lr), jnp.asarray(hr), jnp.asarray(teach))
        _, _, pl = pstep(_t(lr), _t(hr), _t(teach))
        assert _rel(float(pl), float(jl)) <= 1e-5
    _adam_close(pm, params, f"distill {tag}")


def test_calibrate_trunk_scales_match_jax():
    jm, params, pm, lr, _ = _case("tpu_s4")
    want = jel.calibrate_trunk_scales(jm, params, lr)
    got = el.calibrate_trunk_scales(pm, lr)
    assert list(got) == list(want) == ["block0/conv1", "block0/conv2", "block1/conv1", "block1/conv2",
                                       "trunk", "tail"]
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, (k, got[k], want[k])


def test_default_trunk_scales_match_jax():
    """Calibration on the training clips through the video path (both sides
    render and crop the same frames)."""
    jm, params, pm, _, _ = _case("tpu_s4")
    want = jel.default_trunk_scales(jm, params, n_clips=2)
    got = el.default_trunk_scales(pm, n_clips=2)
    assert list(got) == list(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, (k, got[k], want[k])


@pytest.mark.parametrize("arch", ["tpu4b2", "tpu", "lite"])
def test_init_follows_flax_distribution(arch):
    """Each kernel's std within 10% of lecun_normal's sqrt(1/fan_in), its
    values inside the truncation, biases zero; the seed decides the draw."""
    model = ptrain.make_model(arch, 1)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        want = (1.0 / (9 * p.shape[2])) ** 0.5
        assert abs(float(p.std()) / want - 1.0) <= 0.10, (name, float(p.std()), want)
        assert float(p.abs().max()) <= 2 * want / el.TRUNCATED_STD + 1e-6
    again, other = ptrain.make_model(arch, 1), ptrain.make_model(arch, 1, seed=1)
    for (n, a), b, c in zip(model.named_parameters(), again.parameters(), other.parameters()):
        assert torch.equal(a, b)
        assert n.endswith("bias") or not torch.equal(a, c)


def test_init_matches_flax_init_statistics():
    """Against flax's own `init` of the same module: per kernel, the two
    samples' stds within 10% of each other."""
    jm = jel.ESRGANLiteTPU(upscale=2, stride=4, features=128, blocks=2)
    jp = el.params_from_flax(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    pm = ptrain.make_model("tpu4b2", 1)
    for name, p in pm.named_parameters():
        if name.endswith("kernel"):
            assert abs(float(p.std()) / float(jp[name].std()) - 1.0) <= 0.10, name


def test_make_model_covers_every_arch():
    """All seven archs with JAX's keyword arguments, each with the dense
    base; the parameter shapes equal flax's `make_model`'s."""
    for arch, kw in ptrain.ARCHS.items():
        model = ptrain.make_model(arch, 1)
        made = []  # JAX's module; its parameters' shapes traced, not computed
        jp = jax.eval_shape(lambda: made.append(jtrain.make_model(arch, 1)) or made[0][1])
        jm = made[0][0]
        want = {k: tuple(v.shape) for k, v in el.params_from_flax(
            jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), jp)).items()}
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want, arch
        if arch != "lite":
            assert model.base_impl == "conv" and (model.stride, model.features, model.blocks) == (
                jm.stride, jm.features, jm.blocks)


def test_training_reduces_loss(rng):
    """tests/test_esrgan.py::test_training_reduces_loss on the port."""
    model = el.init_params(stages=1, features=16, blocks=2)
    step = el.make_train_step(model, el.adam(model, 1e-3))
    hr = rng.random((4, 32, 32, 3), dtype=np.float32)
    lr, hr = _t(hr[:, ::2, ::2, :]), _t(hr)
    _, _, loss0 = step(lr, hr)
    loss_last = loss0
    for _ in range(10):
        _, _, loss_last = step(lr, hr)
    assert float(loss_last) < float(loss0), f"{loss_last} !< {loss0}"


def test_distill_step_pulls_toward_teacher(rng):
    """tests/test_esrgan.py::test_distill_step_pulls_toward_teacher on the
    port: w = 1 drives the student toward the teacher, not HR."""
    model = el.init_params(stages=1, features=16, blocks=2)
    hr = rng.random((4, 32, 32, 3), dtype=np.float32)
    lr, teach = _t(hr[:, ::2, ::2, :]), _t(np.clip(hr + 0.25, 0.0, 1.0))
    hr = _t(hr)
    step = ptrain.make_distill_step(model, el.adam(model, 1e-2), "l1", w=1.0)
    _, _, loss0 = step(lr, hr, teach)
    for _ in range(30):
        _, _, loss_last = step(lr, hr, teach)
    assert float(loss_last) < float(loss0)
    with torch.no_grad():
        pred = model(lr)
    assert float(el.l1(pred, teach)) < float(el.l1(pred, hr))


@pytest.fixture
def ckpt_root(tmp_path, monkeypatch):
    """The port's CKPT_ROOT (and the JAX side's, unused) under tmp_path; the
    committed weights' listing must not change."""
    monkeypatch.setattr(ptrain, "CKPT_ROOT", tmp_path / "port")
    monkeypatch.setattr(jtrain, "CKPT_ROOT", str(tmp_path / "jax"))
    before = sorted((p.name, p.stat().st_mtime_ns) for p in el.WEIGHTS_DIR.iterdir())
    yield tmp_path / "port"
    assert sorted((p.name, p.stat().st_mtime_ns) for p in el.WEIGHTS_DIR.iterdir()) == before
    assert not (tmp_path / "jax").exists()


def test_checkpoint_round_trip_resume_calibrate_serve(ckpt_root, capsys):
    """`train(steps=2, data="synthetic")` resumes tpu4b2 x2 from the
    committed export (76000) and saves 76002 with Adam's state; a second
    leg resumes from it, optimizer included, and saves 76004. The npz, read
    as a flax tree, gives JAX's `model.apply` the port module's output; the
    CLI's --calibrate --io writes JAX's scales into the sidecar, and
    `load_model(..., directory=)` serves it on the int8 graph."""
    ptrain.train(steps=2, batch=2, arch="tpu4b2", data="synthetic", log_every=1, device="cpu")
    assert "(the committed export)" in capsys.readouterr().out
    assert sorted(p.name for p in ckpt_root.iterdir()) == [
        "esrgan_tpu4b2_x2_76002.json", "esrgan_tpu4b2_x2_76002.npz", "esrgan_tpu4b2_x2_76002_opt.pt"]
    ptrain.train(steps=2, batch=2, arch="tpu4b2", data="synthetic", seed=1, log_every=1, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 76002" in out and "restored optimizer state" in out
    model, meta = el.load_model("tpu4b2", 2, directory=ckpt_root)
    assert meta["step"] == 76004 and meta["model"] == ptrain.ARCHS["tpu4b2"] and meta["upscale"] == 2

    tree, _ = el.load_weights("tpu4b2", 2, directory=ckpt_root)
    jm = jel.ESRGANLiteTPU(upscale=2, stride=4, features=128, blocks=2)
    x = np.random.default_rng(3).random((1, 16, 24, 3), dtype=np.float32)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(_t(x)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-5

    assert ptrain.main(["--arch", "tpu4b2", "--calibrate", "--io", "--device", "cpu"]) == 0
    scales = el.load_act_scales("tpu4b2", 2, directory=ckpt_root)
    want_s = jel.default_trunk_scales(jm, {"params": tree})
    assert scales["head"] == scales["base"] == 1.0
    for k, v in want_s.items():
        assert _rel(scales[k], v) <= 1e-5, (k, scales[k], v)
    sidecar = json.loads((ckpt_root / "esrgan_tpu4b2_x2_76004.json").read_text())
    assert sidecar["act_scales"]["step"] == 76004
    serving = el.make_serving_fn(model, 8, 16, 16, 32, "cpu", quant_scales=scales)
    assert serving.quantized and serving.convs_per_frame == 8
    assert serving(torch.zeros((1, 8, 16, 4), dtype=torch.uint8)).shape == (1, 16, 32, 4)


def test_warm_start_and_fresh_init(ckpt_root, capsys):
    """tpu4b2 x4 has no weights of its own: it warm-starts from tpu4 x4
    (52000) with the last block dropped and saves at 0 + steps; an arch
    without donor or export (tpu8 x4; tpu8 x2 resumes from its export)
    starts from the seeded init."""
    ptrain.train(steps=0, arch="tpu4b2", stages=2, data="synthetic", device="cpu")
    assert "warm-started for tpu4b2 from tpu4 step 52000" in capsys.readouterr().out
    model, step = ptrain.load_checkpoint("tpu4b2", 2)
    donor = el.load_model("tpu4", 4)[0].state_dict()
    assert step == 0 and all(torch.equal(v, donor[k]) for k, v in model.state_dict().items())
    ptrain.train(steps=1, batch=1, arch="tpu8", stages=2, data="synthetic", device="cpu")
    assert "resumed" not in capsys.readouterr().out
    assert (ckpt_root / "esrgan_tpu8_x4_1.json").exists()


def test_evaluate_reports_lanczos3_delta(ckpt_root):
    """The CLI's --eval on the committed tpu4b2 x2: the net beats lanczos3
    on the held-out clips."""
    scores = ptrain.evaluate(1, "tpu4b2", device="cpu")
    assert scores["psnr_delta_db"] > 1.0 and scores["net_psnr_db"] > scores["lanczos3_psnr_db"]


def test_refine_make_model_and_init():
    model = pir.make_model(16, 2)
    assert (model.features, model.blocks, model.stride) == (16, 2, 4)
    assert [n for n, _ in model.named_parameters()] == [
        "head.kernel", "head.bias", "block0.conv1.kernel", "block0.conv1.bias", "block0.conv2.kernel",
        "block0.conv2.bias", "block1.conv1.kernel", "block1.conv1.bias", "block1.conv2.kernel",
        "block1.conv2.bias", "tail.kernel", "tail.bias"]
    assert not any(p.requires_grad for p in model.parameters())  # frozen until a trainer asks
