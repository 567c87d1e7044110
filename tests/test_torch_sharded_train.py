"""The port's dp × tp train step (`nu_scaler_tpu_torch/parallel/mesh.py`
`make_2d_mesh`, `parallel/tp.py`, `models/esrgan_lite.py` `param_shardings`,
`make_sharded_train_step`, `gather_model`) against JAX's
(`nu_scaler_tpu/parallel/mesh.py:40`, `esrgan_lite.py:392-434`) on the
conftest's 8 virtual CPU devices, and against the port's single-device
`make_train_step`, on the CPU.

One world of 4 gloo ranks (`torch_sharded_ranks.run_cases`), spawned once
for the file, runs the 2×2, 1×4 and 4×1 meshes on ESRGANLite(stages=1,
features=16, blocks=2) and ESRGANLiteTPU(upscale=2, stride=2, features=16,
blocks=1), from JAX's flax init, on `tests/test_esrgan.py`'s batch (seed 7,
N = 8, HR 32², LR its [::2, ::2]), three Adam steps at lr 1e-3; JAX's
references are computed while it runs.

Tolerances (fp32 sums in another order on each side):

* the loss: relative 1e-5, against both;
* the gradients and Adam's mu / nu, per leaf, relative to the leaf's largest
  entry: 1e-6 against the port's single-device step; 1e-4 against JAX
  (`tests/test_torch_train.py`'s bound for the port's step against JAX's).
  A bias's gradient is a sum of ±1/n terms that mostly cancel, so the order
  of summation shows: JAX's own sharded step differs from its unsharded one
  by up to 4.4e-5 of the leaf's largest entry there (ESRGANLite's tail
  bias), and the port's single-device step from JAX's by up to 3e-5. A
  gradient off by a power of the mesh's sizes, which Adam's update would
  hide, is off by 50% or more;
* the parameters after each step: 1e-6, against both.
"""

import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_sharded_ranks

from nu_scaler_tpu.models import esrgan_lite as jel
from nu_scaler_tpu.parallel import mesh as jmesh
from nu_scaler_tpu_torch.models import esrgan_lite as el
from nu_scaler_tpu_torch.parallel import mesh as pmesh

LR = 1e-3
STEPS = 3
MESHES = ((2, 2), (1, 4), (4, 1))
# tag: (the JAX module, the port's arch and arguments)
MODELS = {
    "lite": (lambda: jel.ESRGANLite(features=16, blocks=2, stages=1), "lite",
             dict(features=16, blocks=2, stages=1)),
    "tpu": (lambda: jel.ESRGANLiteTPU(upscale=2, stride=2, features=16, blocks=1), "tpu",
            dict(features=16, blocks=1, upscale=2, stride=2)),
}
CASES = [f"{d}x{m} {tag}" for d, m in MESHES for tag in MODELS]
PORT_GRAD_BOUND = 1e-6
JAX_GRAD_BOUND = 1e-4


def _batch():
    rng = np.random.default_rng(7)
    hr = rng.random((8, 32, 32, 3), dtype=np.float32)
    return np.ascontiguousarray(hr[:, ::2, ::2, :]), hr


def _names(tree, prefix: str = "") -> dict:
    """A flax tree's leaves by the port's parameter names."""
    if "params" in tree:
        tree = tree["params"]
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out.update(_names(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _torch(tree) -> dict:
    return el.params_from_flax(jax.device_get(tree))


def _jax_refs(tag: str, params, lr, hr) -> dict:
    """JAX's sharded step on every mesh, three steps: per step the loss,
    `jax.grad` of `l1_loss` at the step's parameters, optax's mu / nu and
    the parameters; and `param_shardings`' specs."""
    jm = MODELS[tag][0]()
    grad = jax.jit(jax.grad(lambda p, x, y: jel.l1_loss(jm, p, x, y)))
    lj, hj = jnp.asarray(lr), jnp.asarray(hr)
    refs = {}
    for d, m in MESHES:
        mesh = jmesh.make_2d_mesh(d, m)
        specs = {n: tuple(s.spec) for n, s in _names(jel.param_shardings(params, mesh)).items()}
        step, sp, state = jel.make_sharded_train_step(jm, optax.adam(LR), mesh, params)
        steps = []
        for _ in range(STEPS):
            g = grad(jax.device_get(sp), lj, hj)
            sp, state, loss = step(sp, state, lj, hj)
            steps.append({"loss": float(loss), "grads": _torch(g), "mu": _torch(state[0].mu),
                          "nu": _torch(state[0].nu), "params": _torch(sp)})
        refs[f"{d}x{m} {tag}"] = {"layout": specs, "steps": steps}
    return refs


def _port_refs(tag: str, state: dict, lr, hr) -> list:
    """The port's single-device step, three steps, as `_jax_refs` records them."""
    _, arch, kwargs = MODELS[tag]
    model = (el.ESRGANLite if arch == "lite" else el.ESRGANLiteTPU)(**kwargs)
    model.load_state_dict(state)
    opt = el.adam(model, LR)
    step = el.make_train_step(model, opt)
    steps = []
    for _ in range(STEPS):
        _, _, loss = step(torch.from_numpy(lr), torch.from_numpy(hr))
        named = list(model.named_parameters())
        steps.append({"loss": float(loss), "grads": {n: p.grad.clone() for n, p in named},
                      "mu": {n: opt.state[p]["exp_avg"].clone() for n, p in named},
                      "nu": {n: opt.state[p]["exp_avg_sq"].clone() for n, p in named},
                      "params": {n: p.detach().clone() for n, p in named}})
    return steps


@pytest.fixture(scope="module")
def world():
    """(the ranks' records, JAX's references, the port's single-device
    references, the initial state dicts): the world runs in its own
    processes while this one computes the references."""
    lr, hr = _batch()
    params = {tag: MODELS[tag][0]().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
              for tag in MODELS}
    states = {tag: _torch(p) for tag, p in params.items()}
    cases = {tag: (MODELS[tag][1], MODELS[tag][2], states[tag]) for tag in MODELS}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pmesh.spawn_world, torch_sharded_ranks.run_cases, "gloo", ["cpu"] * 4,
                            (MESHES, cases, (torch.from_numpy(lr), torch.from_numpy(hr)), STEPS, LR), 240.0)
        jax_refs, port_refs = {}, {}
        for tag in MODELS:
            jax_refs.update(_jax_refs(tag, params[tag], lr, hr))
            port_refs[tag] = _port_refs(tag, states[tag], lr, hr)
        ranks = ranks.result()
    print(f"world and references: {time.perf_counter() - t0:.1f} s")
    return ranks, jax_refs, port_refs, states


def _split(rec: dict, name: str) -> bool:
    return bool(rec["layout"][name])


def _full(ranks: list, key: str, step: int, field: str) -> dict:
    """A field of a step as full tensors: each split leaf the model ranks'
    slices of data rank 0 in model-rank order, each replicated leaf rank 0's."""
    recs = sorted((r[key] for r in ranks if r[key]["coords"][0] == 0), key=lambda r: r["coords"][1])
    return {n: torch.cat([r["steps"][step][field][n] for r in recs], -1) if _split(recs[0], n) else t
            for n, t in recs[0]["steps"][step][field].items()}


def _worst(got: dict, want: dict) -> tuple[float, str]:
    """The largest |Δ| relative to the leaf's largest |entry|, and its leaf."""
    assert sorted(got) == sorted(want)
    return max((float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-30), n) for n in got)


@pytest.mark.parametrize("tag", sorted(MODELS))
@pytest.mark.parametrize("d,m", MESHES)
def test_layout_matches_jax(world, d, m, tag):
    """`param_shardings` gives JAX's specs leaf for leaf, at model size m,
    on every rank."""
    ranks, jax_refs, _, _ = world
    key = f"{d}x{m} {tag}"
    want = jax_refs[key]["layout"]
    for r in ranks:
        assert r[key]["layout"] == want
    if m > 1 and tag == "lite":  # the RGB tail does not divide
        assert want["tail.kernel"] == want["tail.bias"] == ()
    assert want["head.kernel"] == (None, None, None, "model") and want["head.bias"] == ("model",)


@pytest.mark.parametrize("key", CASES)
def test_loss_matches_jax_and_one_device(world, key):
    ranks, jax_refs, port_refs, _ = world
    for s in range(STEPS):
        losses = {r[key]["steps"][s]["loss"] for r in ranks}
        assert len(losses) == 1, f"step {s}: the global loss differs across ranks: {losses}"
        got = losses.pop()
        for want in (jax_refs[key]["steps"][s]["loss"], port_refs[key.split()[1]][s]["loss"]):
            assert abs(got - want) <= 1e-5 * want, (s, got, want)


@pytest.mark.parametrize("field", ["grads", "mu", "nu"])
@pytest.mark.parametrize("key", CASES)
def test_gradients_and_moments_match(world, key, field):
    """The gradients (after the data mean) and Adam's moments after each
    step: against the port's single-device step and against JAX (`jax.grad`
    of `l1_loss`, optax's mu / nu of JAX's sharded step)."""
    ranks, jax_refs, port_refs, _ = world
    for s in range(STEPS):
        got = _full(ranks, key, s, field)
        worst, leaf = _worst(got, port_refs[key.split()[1]][s][field])
        assert worst <= PORT_GRAD_BOUND, (s, leaf, worst)
        worst, leaf = _worst(got, jax_refs[key]["steps"][s][field])
        assert worst <= JAX_GRAD_BOUND, (s, leaf, worst)


@pytest.mark.parametrize("key", CASES)
def test_parameters_match_after_each_step(world, key):
    ranks, jax_refs, port_refs, _ = world
    for s in range(STEPS):
        got = _full(ranks, key, s, "params")
        for want in (jax_refs[key]["steps"][s]["params"], port_refs[key.split()[1]][s]["params"]):
            d = max(float((got[n] - want[n]).abs().max()) for n in got)
            assert d <= 1e-6, (s, d)


@pytest.mark.parametrize("key", CASES)
def test_leaves_agree_across_the_mesh(world, key):
    """After every step a replicated leaf (its gradient, moments and value)
    is equal on every rank, a split one on every data rank of its model
    rank."""
    ranks, _, _, _ = world
    recs = [r[key] for r in ranks]
    for s in range(STEPS):
        for field in ("grads", "mu", "nu", "params"):
            for n in recs[0]["steps"][s][field]:
                split = _split(recs[0], n)
                for r in recs[1:]:
                    if split and r["coords"][1] != recs[0]["coords"][1]:
                        continue
                    assert torch.equal(r["steps"][s][field][n], recs[0]["steps"][s][field][n]), (s, field, n)
                for mr in {r["coords"][1] for r in recs} if split else ():
                    same = [r["steps"][s][field][n] for r in recs if r["coords"][1] == mr]
                    assert all(torch.equal(t, same[0]) for t in same), (s, field, n, mr)


@pytest.mark.parametrize("key", CASES)
def test_gather_model_returns_the_bytes(world, key):
    """`gather_model` of the freshly sharded module is the unsharded module
    bit for bit, on every rank, frozen as a served module."""
    ranks, _, _, states = world
    want = states[key.split()[1]]
    for r in ranks:
        got = r[key]["gathered"]
        assert sorted(got) == sorted(want) and not r[key]["gathered_trainable"]
        for n, t in want.items():
            assert got[n].dtype == t.dtype and torch.equal(got[n], t), n


@pytest.mark.parametrize("key", CASES)
def test_collectives_a_step(world, key):
    """A step makes one gather a split conv (over "model"), one all-reduce
    a split conv whose input takes a gradient (not the head's), and one
    all-reduce over "data" for every gradient and the loss together."""
    ranks, _, _, _ = world
    d, m = (int(v) for v in key.split()[0].split("x"))
    layout = ranks[0][key]["layout"]
    split = sum(1 for n, spec in layout.items() if n.endswith(".kernel") and spec) if m > 1 else 0
    want = {"all_gather": split, "all_reduce": max(split - 1, 0) + (d > 1)}
    for r in ranks:
        for s in range(STEPS):
            assert r[key]["steps"][s]["collectives"] == want, (s, r[key]["steps"][s]["collectives"], want)


@pytest.mark.parametrize("key", CASES)
def test_a_batch_the_data_axis_does_not_divide_raises(world, key):
    ranks, _, _, _ = world
    d = int(key.split("x")[0])
    for r in ranks:
        assert r[key]["odd_batch"].startswith("ValueError") if d > 1 else r[key]["odd_batch"] == "ran"
        assert r[key]["on"] == "cpu"


def test_a_mesh_the_world_does_not_fit_raises(world):
    ranks, _, _, _ = world
    assert all(r["3x1"].startswith("ValueError: a 3 x 1 mesh needs a world of 3 ranks; it has 4") for r in ranks)
    with pytest.raises(ValueError, match="needs a world of 4 ranks; it has 0"):
        pmesh.make_2d_mesh(2, 2, "cpu")  # no world in this process


def test_world_takes_an_explicit_backend_and_device(tmp_path):
    with pytest.raises(ValueError, match="backend must be one of"):
        with pmesh.world(0, 1, "mpi", "cpu", str(tmp_path / "store")):
            pass
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        with pmesh.world(0, 1, "nccl", "cpu", str(tmp_path / "store")):
            pass
    with pytest.raises(TypeError):
        with pmesh.world(0, 1, "gloo", None, str(tmp_path / "store")):
            pass


def test_a_rank_that_raises_fails_the_world():
    """A rank that raises ends the rank waiting for it in a collective, and
    the world raises (the failure of whichever rank ended first: the one that
    raised, or the waiting one, whose peer went away), well before the timeout."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with pytest.raises((mp.ProcessRaisedException, mp.ProcessExitedException)):
        pmesh.spawn_world(torch_sharded_ranks.die_or_wait, "gloo", ["cpu"] * 2, timeout=120.0)
    assert time.perf_counter() - t0 < 60.0
