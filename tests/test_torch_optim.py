"""The rest of the step: AdamW, Nesterov and the unfused update path,
in-step microbatches, and a 2-step AdamW ``fit()``, in the port against the
reference, on the reduced ViT and the reduced qwen2-0.5b with the
reference's weights.

Tolerances:
* the generic update (AdamW, Nesterov, ``fuse=False`` momentum SGD) against
  the reference's ``build_update_fn`` with the reference's noise fed in:
  params and optimizer buffers after two updates within 1e-5 of each
  buffer's largest entry (the reference divides by L where the port
  multiplies by the rounded 1/L, and XLA:CPU contracts products into
  FMAs: a few ULP per op);
* the port's fused and ``fuse=False`` momentum-SGD updates against each
  other: BITWISE (the generic path repeats the kernel's rounded ops in its
  order, and its noise-only draw is the fused path's stream);
* ``microbatches=2`` against the reference's: 2e-5 of the largest summed
  gradient entry (the engines' own bound, test_torch_engines.py);
* the AdamW ``fit()``: masks, σ and ε exact (``float.hex``), params within
  1e-5 of the largest parameter (test_torch_session.py's bounds).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.models import registry as ref_configs
from repro.core import DPConfig as RefDPConfig
from repro.core import engine as ref_engine
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.models.registry import build as ref_build
from repro.utils.params import FlatGradView as RefView
from repro_torch.configs import get_config
from repro_torch.core import DPConfig
from repro_torch.core.engine import (build_accumulate_fn, build_update_fn,
                                     fused_sgd, init_state)
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.data import dataset_for_config
from repro_torch.kernels.noisy_update import (leaf_seed, step_seeds,
                                              threefry_normal, tree_noise,
                                              tree_noisy_update)
from repro_torch.models import build
from repro_torch.optim import adamw, sgd
from repro_torch.utils.params import (FlatGradView, flatten_tree,
                                      params_from_numpy)

ARCHS = ["vit-base", "qwen2-0.5b"]
DP = dict(clip_norm=1.0, noise_multiplier=0.7, expected_batch_size=8.0)
# (reference optimizer, port optimizer, fuse)
OPTIMIZERS = {
    "adamw": (lambda: ref_optim.adamw(1e-2, weight_decay=0.1),
              lambda: adamw(1e-2, weight_decay=0.1), True),
    "nesterov": (lambda: ref_optim.sgd(0.5, momentum=0.9, nesterov=True),
                 lambda: sgd(0.5, momentum=0.9, nesterov=True), True),
    "sgd_unfused": (lambda: ref_optim.sgd(0.5, momentum=0.9),
                    lambda: sgd(0.5, momentum=0.9), False),
}

@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: these tests run many small ops, which stall on
    thread barriers when several test workers share the machine's cores
    (the numbers compared do not depend on the thread count: every side
    of each comparison runs in this process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_configs.get_config(arch).reduced()
    return jax.tree.map(np.asarray, ref_build(cfg).init(
        jax.random.PRNGKey(0)))


def _accs(view, n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = np.zeros(view.total, np.float32)
        a[:view.n_params] = rng.standard_normal(view.n_params)
        out.append(a)
    return out


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_generic_update_matches_reference(arch, opt):
    make_ref, make_port, fuse = OPTIMIZERS[opt]
    rparams = _ref_params(arch)
    ropt, popt = make_ref(), make_port()
    assert not (fuse and fused_sgd(popt))       # the generic path
    rstate = ref_engine.init_state(jax.tree.map(jnp.asarray, rparams), ropt,
                                   jax.random.PRNGKey(1))
    rview = RefView.for_tree(rstate.params)
    rupdate = ref_engine.build_update_fn(ropt, RefDPConfig(**DP), fuse=fuse)
    pstate = init_state(params_from_numpy(rparams, "cpu"), popt, (0, 1))
    view = FlatGradView.for_params(pstate.params)
    pupdate = build_update_fn(popt, DPConfig(**DP), fuse=fuse)
    assert view.total == rview.total
    for acc in _accs(view, 2):
        _, nkey = jax.random.split(rstate.rng)
        z = np.array(rview.noise(nkey))
        rstate = rupdate(rstate._replace(grad_acc=jnp.asarray(acc)))
        pstate.grad_acc.copy_(torch.from_numpy(acc))
        pstate = pupdate(pstate, torch.from_numpy(z))
    for name, w in flatten_tree(jax.tree.map(np.asarray,
                                             rstate.params)).items():
        _close(pstate.params[name].numpy(), w, name)
    for key in ("mom", "mu", "nu"):
        want = rstate.opt_state.get(key)
        if want is None:
            continue
        if isinstance(want, dict):
            want = rview.flatten(want)
        _close(pstate.opt_state[key].numpy(), np.asarray(want), key)
    assert pstate.opt_state["count"] == int(rstate.opt_state["count"]) == 2
    assert not pstate.grad_acc.any()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("private", [True, False], ids=["private",
                                                        "nonprivate"])
def test_fused_and_unfused_sgd_are_bitwise(arch, private):
    """Momentum SGD through the fused kernel's plain version and through
    the generic path (the noise-only draw, the optimizer's update): the
    same params and momentum, bit for bit, over two steps."""
    cfg = DPConfig(**DP, engine="masked_pe" if private else "nonprivate")
    states = []
    for fuse in (True, False):
        st = init_state(params_from_numpy(_ref_params(arch), "cpu"),
                        sgd(0.5, momentum=0.9), (7, 11))
        update = build_update_fn(sgd(0.5, momentum=0.9), cfg, fuse=fuse)
        for acc in _accs(FlatGradView.for_params(st.params), 2):
            st.grad_acc.copy_(torch.from_numpy(acc))
            st.seen = torch.tensor(5.0)
            st = update(st)
        states.append(st)
    fused, generic = states
    for name, p in fused.params.items():
        assert torch.equal(p, generic.params[name]), name
    assert torch.equal(fused.opt_state["mom"], generic.opt_state["mom"])
    assert fused.opt_state["count"] == generic.opt_state["count"] == 2


def test_noise_only_draw_is_the_fused_stream():
    """tree_noise: leaf i is threefry_normal at leaf_seed(seeds, i), the
    alignment tail is zero, and the fused update fed it as an operand
    equals the fused update drawing in the kernel, bitwise."""
    params = params_from_numpy(_ref_params("vit-base"), "cpu")
    view = FlatGradView.for_params(params)
    seeds = step_seeds((0, 1), 3)
    z = tree_noise(params, seeds, view=view)
    for i in range(len(view.names)):
        o, n = view.offsets[i], view.sizes[i]
        assert torch.equal(z[o:o + n], threefry_normal(leaf_seed(seeds, i),
                                                       n, "cpu"))
    assert view.total > view.n_params and not z[view.n_params:].any()
    acc = torch.from_numpy(_accs(view, 1)[0])
    a = {k: v.clone() for k, v in params.items()}
    b = {k: v.clone() for k, v in params.items()}
    tree_noisy_update(a, acc, seeds, 0.7, 8.0, 0.5, view=view)
    tree_noisy_update(b, acc, None, 0.7, 8.0, 0.5, view=view, noise=z)
    for name in params:
        assert torch.equal(a[name], b[name]), name


@functools.lru_cache(maxsize=None)
def _vit_batch():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 100, 8).astype(np.int32)
    return {"image": x, "label": y}, np.array([1, 1, 0, 1, 1, 1, 1, 0],
                                             np.float32)


@pytest.mark.parametrize("engine", ["masked_pe", "masked_fused",
                                    "masked_bk"])
def test_microbatches_match_reference(engine):
    rparams = _ref_params("vit-base")
    rmodel = ref_build(ref_configs.get_config("vit-base").reduced())
    nb, mask = _vit_batch()
    ropt = ref_optim.sgd(0.5)
    rstate = ref_engine.init_state(jax.tree.map(jnp.asarray, rparams), ropt,
                                   jax.random.PRNGKey(1))
    racc = ref_engine.build_accumulate_fn(
        lambda p, b, t: rmodel.loss(p, b, t),
        RefDPConfig(engine=engine, clip_norm=1.0, microbatches=2))
    rstate, _ = jax.jit(racc)(rstate, {k: jnp.asarray(v)
                                       for k, v in nb.items()},
                              jnp.asarray(mask))
    model = build(get_config("vit-base").reduced(), device="cpu")
    st = init_state(params_from_numpy(rparams, "cpu"), sgd(0.5), (0, 1))
    acc = build_accumulate_fn(model.loss, DPConfig(
        engine=engine, clip_norm=1.0, microbatches=2))
    st, metrics = acc(st, {k: torch.from_numpy(v) for k, v in nb.items()},
                      torch.from_numpy(mask))
    want = np.asarray(rstate.grad_acc)
    np.testing.assert_allclose(st.grad_acc.numpy(), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    assert float(st.seen) == float(mask.sum())
    assert 0.0 <= float(metrics["clip_fraction"]) <= 1.0


def test_microbatch_limits():
    with pytest.raises(ValueError, match="microbatches must stay 1"):
        build_accumulate_fn(lambda p, b: None, DPConfig(
            engine="masked_fused_stream", microbatches=2))
    model = build(get_config("vit-base").reduced(), device="cpu")
    st = init_state(model.params(), sgd(0.5), (0, 1))
    nb, mask = _vit_batch()
    acc = build_accumulate_fn(model.loss, DPConfig(engine="masked_pe",
                                                   microbatches=3))
    with pytest.raises(ValueError, match="not a multiple"):
        acc(st, {k: torch.from_numpy(v) for k, v in nb.items()},
            torch.from_numpy(mask))


def test_adamw_fit_matches_reference():
    train = dict(steps=2, n_data=32, physical_batch=4, q=0.25,
                 target_eps=8.0, lr=1e-2, seed=0, optimizer="adamw",
                 weight_decay=0.05)
    ref = RefSession.from_config(
        "vit-base", RefDPConfig(engine="masked_pe", clip_norm=1.0),
        RefTrainConfig(**train))
    p0 = jax.tree.map(np.asarray, ref.state.params)
    view = RefView.for_tree(ref.state.params)
    key, noise = ref.state.rng, []
    for _ in range(2):
        key, nkey = jax.random.split(key)
        noise.append(np.asarray(view.noise(nkey)))
    ref_out = ref.fit()
    port = PrivacySession.from_config(
        "vit-base", DPConfig(engine="masked_pe", clip_norm=1.0),
        TrainConfig(**train), device="cpu",
        params=params_from_numpy(p0, "cpu"))
    out = port.fit(noise=lambda k: torch.tensor(noise[k]))
    assert out["sigma"].hex() == ref_out["sigma"].hex()
    assert float(out["final_eps"]).hex() == float(ref_out["final_eps"]).hex()
    for got, want in zip(out["history"], ref_out["history"]):
        assert got["logical_batch"] == want["logical_batch"]
        assert got["eps"] == want["eps"]
    want = flatten_tree(jax.tree.map(np.asarray, ref.state.params))
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(port.state.params[name].numpy(), w,
                                   rtol=0, atol=1e-5 * scale, err_msg=name)
    assert port.describe()["optimizer"] == "adamw"
    assert port.describe()["microbatches"] == 1


def test_session_optimizer_argument():
    """An ``optimizer=`` replaces the TrainConfig's; Nesterov trains through
    the generic path and reports its kind."""
    opt = sgd(0.1, momentum=0.9, nesterov=True)
    s = PrivacySession.from_config(
        "vit-base", DPConfig(engine="masked_pe", clip_norm=1.0),
        TrainConfig(steps=1, n_data=16, physical_batch=4, q=0.25,
                    target_eps=8.0), device="cpu", optimizer=opt)
    assert s.optimizer is opt and not fused_sgd(opt)
    before = {k: v.clone() for k, v in s.state.params.items()}
    s.fit(dataset_for_config(s.model_cfg, 16, 16, seed=0))
    assert s.state.opt_state["count"] == 1
    assert any(not torch.equal(before[k], v)
               for k, v in s.state.params.items())
    with pytest.raises(ValueError, match="Unknown optimizer"):
        PrivacySession.from_config(
            "vit-base", DPConfig(), TrainConfig(optimizer="lamb"),
            device="cpu")
