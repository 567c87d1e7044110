"""The port's training of the interpolation refinement net (the training half
of `nu_scaler_tpu_torch/models/interp_refine.py`) against the JAX package's
(`nu_scaler_tpu/models/interp_refine.py:64-390`), on the CPU.

* `TripletPool` at 64×256, as the flow tests run, with factors (2, 3) and
  sources ("native", "down4k"): A, B and the target crops equal JAX's (the
  same clips, the same draws); the mids, the port's soft warp against JAX's
  (in interpret mode), meet `tests/test_torch_flow.py`'s bound (≥ 50 dB RGB;
  the tile candidates are not compared here, so no LSB bound);
* the step's loss, with and without its distill term: relative 1e-5; its
  gradients per tensor within 1e-4 · max |g_jax|; Adam steps against
  `optax.adam` as `tests/test_torch_train.py` bounds them (see the test for
  the L1 sign that flips at the third distill step);
* `calibrate_scales`: relative 1e-5.

Every test writes only under `tmp_path` (the port's `CKPT_ROOT` patched).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nu_scaler_tpu.models import interp_refine as ir
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch.models import esrgan_lite as el
from nu_scaler_tpu_torch.models import interp_refine as pir
from nu_scaler_tpu_torch.models import train as ptrain

LR = 2e-4


def _u8(x: np.ndarray) -> np.ndarray:
    return np.round(x * 255.0).astype(np.uint8)


def test_triplet_pool_matches_jax():
    """Two clips of 4 frames: clip 0 "native", clip 1 "down4k"; factors 2
    and 3 give 4 triplets a clip. A, B and the target of a native crop equal
    JAX's; a down4k crop went through the port's area resample, which is
    exact (the float64 golden's bytes, as JAX's at precision "highest"),
    where JAX's pool takes its default "split_bf16" precision, 1 LSB off on
    0.4% of the pixels before the 4:2:0 round trip: those crops are held to
    ≥ 50 dB and ≤ 3 LSB."""
    kw = dict(crop=32, n_clips=2, frames_per_clip=4, pool_size=12, height=64, width=256, factors=(2, 3),
              sources=("native", "down4k"))
    rp, rj = np.random.default_rng(3), np.random.default_rng(3)
    got = pir.TripletPool(rp, device="cpu", **kw)
    want = ir.TripletPool(rj, **kw)
    assert got.xs.shape == (12, 32, 32, 9) and got.ys.shape == (12, 32, 32, 3)
    assert rp.integers(1 << 30) == rj.integers(1 << 30)
    replay = np.random.default_rng(3)
    native = []
    for _ in range(12):  # the pool's draws: triplet, y, x
        native.append(replay.integers(0, 8) < 4)
        replay.integers(0, 33), replay.integers(0, 225)
    native = np.array(native)
    assert native.any() and not native.all()
    np.testing.assert_array_equal(got.xs[native, ..., :6], want.xs[native, ..., :6])
    np.testing.assert_array_equal(got.ys[native], want.ys[native])
    for g, w in ((got.xs[~native, ..., :3], want.xs[~native, ..., :3]),
                 (got.xs[~native, ..., 3:6], want.xs[~native, ..., 3:6]), (got.ys[~native], want.ys[~native])):
        g8, w8 = _u8(g).reshape(-1, 32, 3), _u8(w).reshape(-1, 32, 3)
        assert psnr(g8, w8) >= 50.0 and np.abs(g8.astype(int) - w8).max() <= 3
    mids, jmids = _u8(got.xs[..., 6:9]), _u8(want.xs[..., 6:9])
    np.testing.assert_array_equal(mids.astype(np.float32) / 255.0, got.xs[..., 6:9])
    p = psnr(mids.reshape(-1, 32, 3), jmids.reshape(-1, 32, 3))
    print(f"TripletPool mids: {p:.2f} dB RGB, max {np.abs(mids.astype(int) - jmids).max()} LSB")
    assert p >= 50.0
    assert float(np.abs(got.xs[..., 6:9] - got.ys).mean()) > 1e-4  # something to learn


def _refine_case(features=16, blocks=2, seed=2):
    jm = ir.InterpRefineTPU(features=features, blocks=blocks)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 9), jnp.float32))
    pm = pir.InterpRefine(features=features, blocks=blocks)
    pm.load_state_dict(el.params_from_flax(params))
    return jm, params, pm


def _jax_loss(jm, teacher, w):
    """The loss of JAX's refinement step (interp_refine.py:350-358)."""
    def lf(p, xb, yb):
        mid = xb[..., 6:9]
        pred = mid + jm.apply(p, xb)
        loss = jnp.mean(jnp.abs(pred - yb))
        if teacher is not None:
            t_model, t_params = teacher
            t_pred = mid + jax.lax.stop_gradient(t_model.apply(t_params, xb))
            loss = loss + w * jnp.mean(jnp.abs(pred - t_pred))
        return loss

    return lf


@pytest.mark.parametrize("distill", [False, True])
def test_refine_step_matches_jax(distill):
    jm, params, pm = _refine_case()
    jt = pt = None
    if distill:
        tjm, tparams, pt = _refine_case(8, 1, seed=4)
        jt = (tjm, tparams)
    rng = np.random.default_rng(9)
    xb = rng.random((2, 32, 32, 9), dtype=np.float32)
    yb = np.clip(xb[..., 6:9] + 0.05 * rng.standard_normal((2, 32, 32, 3)), 0, 1).astype(np.float32)
    lf = _jax_loss(jm, jt, 0.5)
    lv, grads = jax.jit(jax.value_and_grad(lf))(params, jnp.asarray(xb), jnp.asarray(yb))
    opt = el.adam(pm, LR)
    with el.fp32_training():
        plv = pir.refine_loss(pm, torch.from_numpy(xb), torch.from_numpy(yb), pt, 0.5)
        plv.backward()
    assert abs(float(plv.detach()) - float(lv)) <= 1e-5 * abs(float(lv))
    want = el.params_from_flax(jax.device_get(grads))
    for name, p in pm.named_parameters():
        assert float((p.grad - want[name]).abs().max()) <= 1e-4 * float(want[name].abs().max()), name
    assert pt is None or all(p.grad is None for p in pt.parameters())  # the teacher stays frozen

    # three Adam steps against optax: 99.9% of the parameters within 1e-6
    # after two, all within 6·lr after three. With the distill term the
    # third step's L1 meets a residual |pred − target| of 3e-7, inside the
    # two sides' difference of the prediction (5e-6 after two steps): its
    # sign flips, and with it that element's share of every gradient (1-4%
    # of the parameters then move by up to 2e-5, a tenth of lr)
    jopt = optax.adam(LR)
    state = jopt.init(params)

    @jax.jit
    def jstep(p, s, x, y):
        jlv, g = jax.value_and_grad(lf)(p, x, y)
        updates, s = jopt.update(g, s, p)
        return optax.apply_updates(p, updates), s, jlv

    pm.load_state_dict(el.params_from_flax(params))
    pstep = el.make_step(pm, el.adam(pm, LR), lambda x, y: pir.refine_loss(pm, x, y, pt, 0.5))
    for i in range(3):
        params, state, jl = jstep(params, state, jnp.asarray(xb), jnp.asarray(yb))
        _, _, pl = pstep(torch.from_numpy(xb), torch.from_numpy(yb))
        assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
        got = el.params_from_flax(jax.device_get(params))
        diffs = np.concatenate([(p.detach() - got[n]).abs().flatten().numpy() for n, p in pm.named_parameters()])
        assert diffs.max() <= 6 * LR
        if i < 2:
            assert (diffs <= 1e-6).mean() >= 0.999


@pytest.mark.parametrize("include_head", [True, False])
def test_calibrate_scales_match_jax(include_head):
    jm, params, pm = _refine_case()
    crops = np.random.default_rng(5).random((3, 32, 32, 9), dtype=np.float32)
    want = ir.calibrate_scales(params, crops=crops, include_head=include_head)
    got = pir.calibrate_scales(pm, crops=crops, include_head=include_head, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])


@pytest.fixture
def ckpt_root(tmp_path, monkeypatch):
    """The port's CKPT_ROOT under tmp_path; the committed weights' listing
    must not change."""
    monkeypatch.setattr(ptrain, "CKPT_ROOT", tmp_path)
    before = sorted((p.name, p.stat().st_mtime_ns) for p in el.WEIGHTS_DIR.iterdir())
    yield tmp_path
    assert sorted((p.name, p.stat().st_mtime_ns) for p in el.WEIGHTS_DIR.iterdir()) == before


class _StubPool:
    """tests/test_interp_refine.py's stand-in pool: random crops, off the
    clock (the real pool is covered above)."""

    def __init__(self, rng, **kw):
        crop, n = kw.get("crop", 16), kw.get("pool_size", 8)
        self.xs = rng.random((n, crop, crop, 9), dtype=np.float32)
        self.ys = rng.random((n, crop, crop, 3), dtype=np.float32)


def test_named_checkpoints_and_distill_leg(ckpt_root, monkeypatch):
    """tests/test_interp_refine.py::test_named_checkpoints_and_distill_leg on
    the port: named nets save and load under CKPT_ROOT/<name>/ beside the
    serving net without touching it, and a distill leg trains against the
    frozen teacher."""
    monkeypatch.setattr(pir, "TripletPool", _StubPool)
    pir.train(steps=2, batch=2, n_clips=1, pool_size=8, height=96, width=160, crop=16, log_every=1,
              features=16, blocks=2, name="t_teacher", device="cpu")
    assert (ckpt_root / "t_teacher" / "t_teacher_2.json").exists()
    pir.train(steps=2, batch=2, n_clips=1, pool_size=8, height=96, width=160, crop=16, log_every=1,
              features=8, blocks=1, name="t_student", distill=("t_teacher", 16, 2), distill_w=0.5, device="cpu")
    model, step = pir.load_checkpoint("t_student")
    assert step == 2 and (model.features, model.blocks) == (8, 1)
    # the serving net's loaders never see the named nets: CKPT_ROOT holds no
    # interp_ref4, so its committed export resolves
    assert pir.load_checkpoint()[1] == 112000
    assert pir.load_model()[1]["step"] == 112000 and pir.load_act_scales() is None
    with pytest.raises(ValueError, match="not 9/1"):
        pir.train(steps=1, batch=2, pool_size=8, crop=16, features=8, blocks=1, name="t_student2",
                  distill=("t_teacher", 9, 1), device="cpu")


def test_train_resumes_the_serving_net_and_serves_it(ckpt_root):
    """A leg of interp_ref4 on a real pool at 64x256 resumes from the
    committed 112000 (the cached serving module untouched), saves 112002;
    its calibration goes into the sidecar, and `RefineGraph` serves the
    trained module; the held-out float eval reads it."""
    served = pir.load_model()[0]
    before = {k: v.clone() for k, v in served.state_dict().items()}
    loss = pir.train(steps=2, batch=2, crop=32, n_clips=1, pool_size=8, height=64, width=256, log_every=1,
                     device="cpu")
    assert np.isfinite(loss)
    assert all(torch.equal(v, before[k]) for k, v in served.state_dict().items())
    assert not any(p.requires_grad for p in served.parameters())
    model, step = pir.load_checkpoint()
    assert step == 112002
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())
    crops = pir.TripletPool(np.random.default_rng(7), crop=32, n_clips=1, frames_per_clip=3, pool_size=4,
                            height=64, width=256, device="cpu").xs
    scales = pir.calibrate_scales(model, crops=crops, device="cpu")
    pir.save_act_scales(scales, step)
    meta = el.newest_sidecar(ckpt_root / pir.NET, f"{pir.NET}_*.json")
    assert el.sidecar_scales(meta) == scales
    rng = np.random.default_rng(0)
    a, b, mid = (torch.from_numpy(rng.integers(0, 256, (64, 256, 4), dtype=np.uint8)) for _ in range(3))
    out = pir.RefineGraph(model, 64, 256, "cpu")(a, b, mid)
    q_out = pir.RefineGraph(model, 64, 256, "cpu", quant_scales=scales)(a, b, mid)
    assert out.shape == q_out.shape == (64, 256, 4) and torch.equal(out[..., 3], mid[..., 3])
    res = pir.eval_refine_float(seeds=(900,), frames=3, height=64, width=256, device="cpu")
    assert res["step"] == 112002 and np.isfinite(res["psnr_delta_db"])
