"""A training step resumed from the committed export with Adam's exported
moments (`nu_scaler_tpu_torch/models/train.py` `load_export_opt_state`)
against the JAX trainer's resume from the orbax checkpoint and its
``{step}_opt`` tree (`nu_scaler_tpu/models/train.py` `load_checkpoint`,
`load_opt_state`), on the CPU, on the same seeded numpy batch.

Bounds: `tests/test_torch_train.py`'s: the loss within a relative 1e-5, the
parameters after the step 99.9% within 1e-6 and all within 6·lr (a near-zero
gradient's sign at L1's kink). Without the moments the port's step lands
elsewhere: that is the fault the export repairs.
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
from nu_scaler_tpu_torch.models import train as ptrain

LR = 2e-4
ARCH, STAGES, STEP = "tpu4b2", 1, 76000


def _batch():
    """lr [2, 32, 32, 3] (the 2×2 area mean) and hr [2, 64, 64, 3] in [0, 1]."""
    hr = np.random.default_rng(11).random((2, 64, 64, 3), dtype=np.float32)
    return hr.reshape(2, 32, 2, 32, 2, 3).mean(axis=(2, 4)), hr


@pytest.fixture(scope="module")
def jax_step():
    """JAX's params after one step resumed from 76000 with its Adam state,
    the step's loss, and the restored Adam count."""
    params, step = jtrain.load_checkpoint(STAGES, ARCH)
    assert step == STEP
    jm = jel.ESRGANLiteTPU(upscale=2 ** STAGES, **ptrain.ARCHS[ARCH])
    opt = optax.adam(LR)
    state = jtrain.load_opt_state(opt.init(params), STAGES, STEP, ARCH)
    assert state is not None, "the orbax Adam state must restore"
    lr, hr = _batch()
    after, _, loss = jel.make_train_step(jm, opt, "l1")(params, state, jnp.asarray(lr), jnp.asarray(hr))
    return el.params_from_flax(jax.device_get(after)), float(loss), int(state[0].count)


def _port_step(with_moments: bool):
    model, step = ptrain.load_checkpoint(ARCH, STAGES, el.WEIGHTS_DIR)
    assert step == STEP
    opt = el.adam(model, LR)
    if with_moments:
        assert ptrain.load_export_opt_state(opt, model, ARCH, STAGES, STEP)
    lr, hr = (torch.from_numpy(np.ascontiguousarray(a)) for a in _batch())
    _, _, loss = el.make_train_step(model, opt, "l1")(lr, hr)
    return model, opt, float(loss)


def _diffs(model, want: dict) -> np.ndarray:
    return np.concatenate([(p.detach() - want[n]).abs().flatten().numpy()
                           for n, p in model.named_parameters()])


def test_resume_with_the_exported_moments_matches_jax(jax_step):
    want, jax_loss, count = jax_step
    model, opt, loss = _port_step(with_moments=True)
    assert abs(loss - jax_loss) <= 1e-5 * abs(jax_loss), (loss, jax_loss)
    diffs = _diffs(model, want)
    within = float((diffs <= 1e-6).mean())
    print(f"with the moments: {within:.6f} of {diffs.size} within 1e-6, max {diffs.max():.3g}")
    assert within >= 0.999 and diffs.max() <= 6 * LR
    # PyTorch's step counter took over optax's count, and went one further
    assert all(float(s["step"]) == count + 1 for s in opt.state.values())


def test_resume_without_the_moments_differs(jax_step):
    want, jax_loss, _ = jax_step
    model, _, loss = _port_step(with_moments=False)
    assert abs(loss - jax_loss) <= 1e-5 * abs(jax_loss)  # the same weights before the step
    diffs = _diffs(model, want)
    within = float((diffs <= 1e-6).mean())
    print(f"without the moments: {within:.6f} of {diffs.size} within 1e-6, max {diffs.max():.3g}")
    assert within < 0.999 or diffs.max() > 6 * LR


def test_exported_moments_are_checked_and_mapped(monkeypatch):
    """The npz's sha256 must be its sidecar's; every parameter gets both
    moments at its own shape; an export without moments restores nothing."""
    model, _ = ptrain.load_checkpoint(ARCH, STAGES, el.WEIGHTS_DIR)
    opt = el.adam(model, LR)
    assert ptrain.load_export_opt_state(opt, model, ARCH, STAGES, STEP)
    for p in model.parameters():
        st = opt.state[p]
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape
        assert float(st["exp_avg_sq"].min()) >= 0.0
    assert not ptrain.load_export_opt_state(el.adam(model, LR), model, ARCH, STAGES, STEP + 1)
    real = el._sidecar

    def tampered(*args, **kwargs):
        meta = real(*args, **kwargs)
        return {**meta, "opt_sha256": "0" * 64}

    monkeypatch.setattr(el, "_sidecar", tampered)
    with pytest.raises(ValueError, match="sha256"):
        ptrain.load_export_opt_state(el.adam(model, LR), model, ARCH, STAGES, STEP)
    json.dumps(real(ARCH, 2 ** STAGES))  # the real sidecar is untouched
