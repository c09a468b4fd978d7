"""The clipping engines, the expert-stacked tape and
``PrivacySession.fit()`` on the port's MoE family (reduced olmoe-1b-7b and
deepseek-v2-lite-16b) against the reference's, with the reference's
weights and inputs made from a numpy seed.

At T = 64 the Mixed-Ghost rule (direct when T^2 > din dout) sends the
router (128 x 4) of every MoE layer and MLA's RoPE key ``wkr`` (128 x 16)
of every layer to the direct path (the ``ghost_norm_dense`` wrapper), and
everything else to the Gram path, as at full width and T = 1,024: MLA's
``wdkv`` (128 x 32, T^2 = din dout = 4,096) sits on the boundary and
takes the Gram path, as full width's (2,048 x 512) does; every expert
dense runs at T = cap = 40 on the Gram path.

The reference fails ``tests/test_engine_e2e.py::
test_streaming_parity_all_archs[deepseek-v2-lite-16b]``: its streaming
engine is not bitwise to its ``masked_pe`` on that arch.  No test here
holds the port to that point; the port's own claim, the stream bitwise to
``masked_pe`` at tile = batch, is tested below on both models.

Tolerances (f32):
* every engine's clipped sum (``masked_pe``, ``masked_fused``,
  ``masked_fused_stream`` at a tile of 4 below the batch of 6,
  ``masked_ghost``, ``masked_bk``) against the reference's: 2e-5 of the
  largest entry; norms 2e-5 relative; clip coefficients 2e-5 absolute
  (the bounds of the other families).
* 2-step ``fit()`` with the reference's noise fed in: masks, σ and ε
  exact; params and momentum 1e-5 of the largest parameter; logged losses
  1e-3 (test_torch_denselm_session.py's bounds).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPConfig as RefDPConfig
from repro.core import clipping as ref_clipping
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.core.tape import Tape as RefTape
from repro.models.registry import build as ref_build
from repro.models.registry import get_config as ref_get_config
from repro.utils.params import FlatGradView as RefView
from repro_torch.configs import get_config
from repro_torch.core import DPConfig, clipping
from repro_torch.core import layers as L
from repro_torch.core.engine import TrainState, build_accumulate_fn
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.kernels import ghost_norm as gn
from repro_torch.models import build, moe
from repro_torch.utils.params import (FlatGradView, flatten_tree,
                                      params_from_numpy)

B, T = 6, 64
MASK = np.array([1, 1, 0, 1, 1, 1], np.float32)
ENGINES = ["masked_pe", "masked_fused", "masked_fused_stream",
           "masked_ghost", "masked_bk"]
MOE = {"olmoe": "olmoe-1b-7b", "deepseek": "deepseek-v2-lite-16b"}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: many small ops stall on thread barriers when
    several test workers share the machine's cores (every side of each
    comparison runs in this process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _lm(name):
    """The reference's loss, params and batch, and the port's, with the
    reference's weights (initialised under ``jit``)."""
    rmodel = ref_build(ref_get_config(MOE[name]).reduced())
    rparams = jax.jit(rmodel.init)(jax.random.PRNGKey(0))
    model = build(get_config(MOE[name]).reduced(), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab, (B, T + 1)).astype(np.int32)
    return (lambda p, b, t: rmodel.loss(p, b, t), rparams,
            {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            model.loss, params,
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


def _hold(got, rsum, tol=2e-5):
    want = flatten_tree(jax.tree.map(np.asarray, rsum))
    assert set(want) == set(got)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(MOE))
def test_engines_match_reference(name, engine):
    rloss, rparams, rbatch, loss, params, batch = _lm(name)
    kw = {"tile": 4} if engine == "masked_fused_stream" else {}
    rsum, raux = jax.jit(lambda p, b, m: ref_clipping.ENGINES[engine](
        rloss, p, b, m, 1.0, **kw))(rparams, rbatch, jnp.asarray(MASK))
    if engine == "masked_bk":
        kw = {"check_coverage": True}
    tsum, taux = clipping.resolve_engine(engine)(
        loss, params, batch, torch.from_numpy(MASK), 1.0, **kw)
    assert list(tsum) == list(params)
    _hold(tsum, rsum)
    np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                               np.asarray(raux["per_example_norms"]),
                               rtol=2e-5)
    np.testing.assert_allclose(taux["clip_coef"].numpy(),
                               np.asarray(raux["clip_coef"]), rtol=0,
                               atol=2e-5)
    assert float(taux["clip_coef"][2]) == 0.0


@pytest.mark.parametrize("name,direct", [
    ("olmoe", [(64, 128, 4)] * 2),
    ("deepseek", [(64, 128, 16)] * 2 + [(64, 128, 4)])])
def test_router_and_rope_key_take_the_direct_path(name, direct,
                                                   monkeypatch):
    """One norm pass: the kernel's wrapper runs once per router (olmoe's
    2 layers) and once per ``wkr`` and router (deepseek: 2 ``wkr``, 1
    router), and nowhere else; the norms match the reference's."""
    rloss, rparams, rbatch, loss, params, batch = _lm(name)
    calls = []
    monkeypatch.setattr(L, "ghost_norm_dense",
                        lambda x, d: calls.append(tuple(x.shape[1:])
                                                  + (d.shape[2],))
                        or gn.ghost_norm_dense(x, d))
    sq, _ = clipping.ghost_norms(loss, params, batch)
    assert sorted(calls) == sorted(direct)
    want, _ = jax.jit(lambda p, b: ref_clipping.ghost_norms(rloss, p, b))(
        rparams, rbatch)
    np.testing.assert_allclose(sq.numpy(), np.asarray(want), rtol=2e-5)


def _stacked(a):
    return torch.stack([_stacked(v) for v in a]) if isinstance(a, list) \
        else a


@pytest.mark.parametrize("name", sorted(MOE))
def test_tape_stacks_experts_as_the_reference_does(name):
    """Specs in the reference's insertion order with its kinds, stacks
    (('layers', 'layers') for the experts: the layer scan's list level
    outside, the E tensor axis inside), parameter paths and metas
    (``record_of`` on w3); dY stack to the reference's eps shapes."""
    rloss, rparams, rbatch, loss, params, batch = _lm(name)
    rtape = RefTape(RefTape.COLLECT)
    jax.eval_shape(lambda p, b: rloss(p, b, rtape), rparams, rbatch)
    dEps, records, specs, _ = clipping._eps_backward(loss, params, batch)
    assert list(specs) == list(rtape.specs)
    for n, spec in specs.items():
        rs = rtape.specs[n]
        assert (spec.kind, spec.stack, spec.param_path, spec.meta) == (
            rs.kind, rs.stack, rs.param_path, rs.meta), n
        assert tuple(_stacked(dEps[n]).shape) == rtape.eps[n].shape
    scope = "blocks" if name == "olmoe" else "moe_blocks"
    x = records[f"{scope}/moe.w13.a"]["x"]
    E = get_config(MOE[name]).reduced().n_experts
    assert isinstance(x, list) and x[0].shape[:2] == (E, B)
    assert records[f"{scope}/moe.w13.b"] == {}
    assert specs[f"{scope}/moe.w2"].stack == ("layers", "layers")


@pytest.mark.parametrize("name", sorted(MOE))
def test_stream_is_bitwise_to_masked_pe_at_tile_batch(name):
    """The port's claim on both models: ``masked_fused_stream`` at tile =
    batch adds masked_pe's clipped sum bit for bit; ``masked_fused`` too."""
    *_, loss, params, batch = _lm(name)
    mask = torch.from_numpy(MASK)
    view = FlatGradView.for_params(params)
    summed, _ = clipping.resolve_engine("masked_pe")(loss, params, batch,
                                                     mask, 1.0)
    want = view.flatten(summed)
    acc = view.zeros("cpu")
    clipping.resolve_engine("masked_fused_stream")(
        loss, params, batch, mask, 1.0, acc=acc, view=view, tile=B)
    assert torch.equal(acc, want)
    fused, _ = clipping.resolve_engine("masked_fused")(loss, params, batch,
                                                       mask, 1.0)
    assert torch.equal(view.flatten(fused), want)


@pytest.mark.parametrize("name", sorted(MOE))
def test_routing_agrees_between_batched_and_per_example_forwards(name):
    """The routing the per-example engines' forward (one example at a
    time under ``vmap``) selects equals the batched forward's (the record
    engines'), layer by layer; and so does its kept mask."""
    *_, loss, params, batch = _lm(name)
    batched = moe.routing(loss, params, batch)
    per = moe.routing(loss, params, batch, per_example=True)
    n_moe = get_config(MOE[name]).reduced()
    assert len(batched) == len(per) == (n_moe.n_layers
                                        - n_moe.first_dense_layers)
    for (e1, v1), (e2, v2) in zip(batched, per):
        assert e1.shape == (B, T * n_moe.top_k)
        assert torch.equal(e1, e2) and torch.equal(v1, v2)


@pytest.mark.parametrize("engine", ["masked_pe", "masked_ghost",
                                    "masked_bk", "masked_fused_stream"])
def test_masked_out_examples_add_exactly_zero(engine):
    """Capacity comes from T alone, so an example's routing and its
    gradient do not depend on the others: with every example masked out,
    deepseek's accumulate leaves the accumulator exactly 0."""
    *_, loss, params, batch = _lm("deepseek")
    state = TrainState(params=params, opt_state={},
                       grad_acc=FlatGradView.for_params(params).zeros("cpu"),
                       rng=(0, 0), seen=torch.zeros(()))
    acc_fn = build_accumulate_fn(loss, DPConfig(
        engine=engine, clip_norm=1.0,
        stream_tile=B if engine == "masked_fused_stream" else None))
    acc_fn(state, batch, torch.zeros(B))
    assert int(torch.count_nonzero(state.grad_acc)) == 0


TRAIN = dict(steps=2, n_data=32, seq_len=16, physical_batch=4, q=0.25,
             target_eps=8.0, lr=0.5, seed=0, smoke=True)


def _reference_noise(ref, steps):
    view = RefView.for_tree(ref.state.params)
    key, out = ref.state.rng, []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.asarray(view.noise(nkey)))
    return out


@pytest.mark.parametrize("name,engine", [("olmoe", "masked_bk"),
                                         ("deepseek", "masked_fused_stream")])
def test_fit_matches_reference(name, engine):
    """2 steps at 16 tokens, the reference's noise fed in as the update's
    operand: olmoe through book-keeping (its expert BK grads, (n, E, d, f),
    are the update), deepseek through the streaming engine."""
    ref = RefSession.from_config(
        MOE[name], RefDPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        RefTrainConfig(**TRAIN))
    p0 = jax.tree.map(np.asarray, ref.state.params)
    noise = _reference_noise(ref, TRAIN["steps"])
    ref_out = ref.fit()

    port = PrivacySession.from_config(
        MOE[name], DPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        TrainConfig(**TRAIN), device="cpu", params=params_from_numpy(p0,
                                                                     "cpu"))
    out = port.fit(noise=lambda k: torch.tensor(noise[k]))

    assert out["sigma"].hex() == ref_out["sigma"].hex()
    assert float(out["final_eps"]).hex() == float(ref_out["final_eps"]).hex()
    assert len(out["history"]) == len(ref_out["history"]) == 2
    for got, want in zip(out["history"], ref_out["history"]):
        assert got["logical_batch"] == want["logical_batch"]
        assert got["eps"] == want["eps"]
        assert got["loss"] == pytest.approx(want["loss"], abs=1e-3)
    want = flatten_tree(jax.tree.map(np.asarray, ref.state.params))
    scale = max(float(np.abs(v).max()) for v in want.values())
    moved = 0.0
    for k, w in want.items():
        np.testing.assert_allclose(port.state.params[k].numpy(), w, rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
        moved = max(moved, float(np.abs(w - flatten_tree(p0)[k]).max()))
    assert moved > 1e-3
    np.testing.assert_allclose(port.state.opt_state["mom"].numpy(),
                               np.asarray(ref.state.opt_state["mom"]),
                               rtol=0, atol=1e-5 * scale)
