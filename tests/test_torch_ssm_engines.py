"""The clipping engines, the nested-stack tape and ``PrivacySession.fit()``
on the port's Mamba2 and Zamba2 against the reference's, with the
reference's weights and inputs made from a numpy seed.

At T = 128 the narrow hybrid (``attn_every`` 2, 5 layers: 2 supers of 2
mamba layers and a tail of 1) folds its 2 uses of the shared block into
T_eff = 256, so the Mixed-Ghost rule sends the shared block's seven denses
(wq, wk, wv, wo 128 x 128; w1, w3 128 x 256; w2 256 x 128) and the head
(128 x 97) to the direct path (the ``ghost_norm_dense`` wrapper), and the
mamba projections to the Gram path, as at full width, where zamba2's T_eff
is 6,144.

The reference fails ``tests/test_analysis.py::test_full_matrix[masked_bk-
mamba2-1.3b]`` in its privacy verifier; no test here holds the port to any
point of that test.

Tolerances (f32):
* every engine's clipped sum (``masked_pe``, ``masked_fused``,
  ``masked_fused_stream`` at a tile of 4 below the batch of 6,
  ``masked_ghost``, ``masked_bk``) against the reference's: 2e-5 of the
  largest entry; norms 2e-5 relative; clip coefficients 2e-5 absolute
  (the ViT's and DenseLM's bounds; measured up to 2.4e-6).
* the layer companions on nested stacks (('layers', 'layers'), ('uses',),
  ('layers', 'uses')) against the reference's: norms 1e-5 relative, BK
  grads 1e-5 of the largest entry (test_torch_ghost.py's bounds).
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
from repro.core import layers as ref_layers
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.core.tape import LayerSpec as RefSpec
from repro.core.tape import Tape as RefTape
from repro.models.registry import build as ref_build
from repro.models.registry import get_config as ref_get_config
from repro.utils.params import FlatGradView as RefView
from repro_torch.configs import get_config
from repro_torch.core import DPConfig, clipping
from repro_torch.core import layers as L
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.core.tape import LayerSpec
from repro_torch.kernels import ghost_norm as gn
from repro_torch.models import build
from repro_torch.utils.params import flatten_tree, params_from_numpy

B = 6
MASK = np.array([1, 1, 0, 1, 1, 1], np.float32)
ENGINES = ["masked_pe", "masked_fused", "masked_fused_stream",
           "masked_ghost", "masked_bk"]
MODELS = {"mamba2": ("mamba2-1.3b", {}),
          "hybrid5": ("zamba2-1.2b", dict(attn_every=2, n_layers=5))}


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
def _models(name):
    """The reference model and its parameters (initialised under ``jit``),
    and the port's model with the same weights."""
    arch, over = MODELS[name]
    rmodel = ref_build(ref_get_config(arch).reduced(**over))
    rparams = jax.jit(rmodel.init)(jax.random.PRNGKey(0))
    model = build(get_config(arch).reduced(**over), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    return rmodel, rparams, model, params


@functools.lru_cache(maxsize=None)
def _lm(name, T=128):
    rmodel, rparams, model, params = _models(name)
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
@pytest.mark.parametrize("name", sorted(MODELS))
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


def test_shared_block_takes_the_direct_path_once_per_dense(monkeypatch):
    """One norm pass of the narrow hybrid: the kernel's wrapper runs once
    for each of the shared block's seven denses, on the records of both
    uses folded into T_eff = 256, and once for the head; the norms match
    the reference's."""
    rloss, rparams, rbatch, loss, params, batch = _lm("hybrid5")
    calls = []
    monkeypatch.setattr(L, "ghost_norm_dense",
                        lambda x, d: calls.append(tuple(x.shape[1:])
                                                  + (d.shape[2],))
                        or gn.ghost_norm_dense(x, d))
    sq, _ = clipping.ghost_norms(loss, params, batch)
    assert sorted(calls) == sorted([(256, 128, 128)] * 4
                                   + [(256, 128, 256)] * 2
                                   + [(256, 256, 128), (128, 128, 97)])
    want, _ = jax.jit(lambda p, b: ref_clipping.ghost_norms(rloss, p, b))(
        rparams, rbatch)
    np.testing.assert_allclose(sq.numpy(), np.asarray(want), rtol=2e-5)


def _stacked(a):
    return torch.stack([_stacked(v) for v in a]) if isinstance(a, list) \
        else a


def test_tape_nests_stacks_as_the_reference_does():
    """Specs in the reference's insertion order with its kinds, stacks
    (('layers', 'layers') for supers.inner, ('uses',) for the shared block,
    ('layers',) for the tail) and parameter paths; records and dY nest one
    list level per stack and stack to the reference's eps shapes."""
    rloss, rparams, rbatch, loss, params, batch = _lm("hybrid5", T=16)
    rtape = RefTape(RefTape.COLLECT)
    jax.eval_shape(lambda p, b: rloss(p, b, rtape), rparams, rbatch)
    dEps, records, specs, _ = clipping._eps_backward(loss, params, batch)
    assert list(specs) == list(rtape.specs)
    for name, spec in specs.items():
        rs = rtape.specs[name]
        assert (spec.kind, spec.stack, spec.param_path, spec.meta) == (
            rs.kind, rs.stack, rs.param_path, rs.meta), name
        assert tuple(_stacked(dEps[name]).shape) == rtape.eps[name].shape
    assert specs["supers/inner/mamba.in_proj"].stack == ("layers", "layers")
    assert specs["supers/shared/attn.wq"].stack == ("uses",)
    assert specs["tailb/mamba.conv"].stack == ("layers",)
    x = records["supers/inner/mamba.in_proj"]["x"]
    assert len(x) == 2 and len(x[0]) == 2 and torch.is_tensor(x[0][0])


# the companions on nested stacks: kind -> (record keys, spec meta)
KINDS = {"dense": (("x",), (("has_bias", True),)),
         "scale": (("x",), (("gdim", 1),)),
         "bias": ((), (("bdim", 1),)),
         "conv1d": (("x",), (("width", 4),)),
         "embed": (("ids",), (("vocab", 11),))}
STACKS = [("layers", "layers"), ("uses",), ("layers", "uses")]
# a depthwise conv is never re-used across a folded axis (its window would
# run across uses), and the reference's companion takes no 'uses' fold
CASES = [(k, s) for k in sorted(KINDS) for s in STACKS
         if not (k == "conv1d" and "uses" in s)]


def _nest(a, depth):
    """A stacked array as nested lists of torch tensors, ``depth`` levels."""
    if depth == 0:
        return torch.from_numpy(np.ascontiguousarray(a))
    return [_nest(v, depth - 1) for v in a]


@pytest.mark.parametrize("kind,stack", CASES,
                         ids=[f"{k}-{'-'.join(s)}" for k, s in CASES])
def test_nested_stack_companions_match_reference(kind, stack):
    """per_example_sq_norm and bk_grads of one primitive whose records
    carry nested stack axes (the port: one list level per axis; the
    reference: leading array axes) against the reference's companions;
    BK grads keep every 'layers' axis ((2, 3, ...) for two nested
    stacks)."""
    rng = np.random.default_rng(11)
    lead = (2, 3)[:len(stack)]
    b, t, din, dout = 3, 5, 6, 4
    keys, meta = KINDS[kind]
    rec = {}
    if "x" in keys:
        rec["x"] = rng.standard_normal(lead + (b, t, din)).astype(np.float32)
    if "ids" in keys:
        rec["ids"] = rng.integers(0, 11, lead + (b, t)).astype(np.int32)
    width = {"dense": dout, "conv1d": din, "embed": dout}.get(kind, din)
    dy = rng.standard_normal(lead + (b, t, width)).astype(np.float32)
    coef = np.array([0.5, 0.0, 1.25], np.float32)
    rspec = RefSpec(kind, stack=stack, param_path="p", meta=meta)
    spec = LayerSpec(kind, stack=stack, param_path="p", meta=meta)
    trec = {k: _nest(v, len(stack)) for k, v in rec.items()}
    tdy = _nest(dy, len(stack))
    want = ref_layers.per_example_sq_norm(
        rspec, {k: jnp.asarray(v) for k, v in rec.items()}, jnp.asarray(dy))
    got = L.per_example_sq_norm(spec, trec, tdy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    rbk = ref_layers.bk_grads(
        rspec, {k: jnp.asarray(v) for k, v in rec.items()}, jnp.asarray(dy),
        jnp.asarray(coef))
    tbk = L.bk_grads(spec, trec, tdy, torch.from_numpy(coef))
    assert set(tbk) == set(rbk)
    n_layers = stack.count("layers")
    for k, w in rbk.items():
        w = np.asarray(w)
        assert tuple(tbk[k].shape) == w.shape, k
        assert w.shape[:n_layers] == lead[:n_layers], k
        np.testing.assert_allclose(tbk[k].numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_single_stacks_are_unchanged():
    """One 'layers' level: the per-layer lists are read in place (the
    records' tensors are the ones passed in, not copies) and the BK grads
    stack on one leading axis."""
    rng = np.random.default_rng(12)
    xs = [torch.from_numpy(rng.standard_normal((3, 5, 6)).astype(np.float32))
          for _ in range(2)]
    dys = [torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(np.float32))
           for _ in range(2)]
    spec = LayerSpec("dense", stack=("layers",), param_path="p",
                     meta=(("has_bias", False),))
    rec, dy, nl = L._fold(spec, {"x": xs}, dys)
    assert nl == 1 and rec["x"] is xs and dy is dys
    g = L.bk_grads(spec, {"x": xs}, dys, torch.ones(3))["p.w"]
    want = torch.stack([torch.einsum("bti,bto->io", x, d)
                        for x, d in zip(xs, dys)])
    assert torch.equal(g, want)


TRAIN = dict(steps=2, n_data=32, seq_len=16, physical_batch=4, q=0.25,
             target_eps=8.0, lr=0.5, seed=0, smoke=False)


def _reference_noise(ref, steps):
    view = RefView.for_tree(ref.state.params)
    key, out = ref.state.rng, []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.asarray(view.noise(nkey)))
    return out


@pytest.mark.parametrize("name,engine", [("mamba2", "masked_fused_stream"),
                                         ("hybrid5", "masked_bk")])
def test_fit_matches_reference(name, engine):
    """2 steps at 16 tokens, the reference's noise fed in as the update's
    operand: the narrow hybrid through book-keeping (its nested BK grads
    are the update), mamba2 through the streaming engine."""
    arch, over = MODELS[name]
    ref = RefSession.from_config(
        ref_get_config(arch).reduced(**over),
        RefDPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        RefTrainConfig(**TRAIN))
    p0 = jax.tree.map(np.asarray, ref.state.params)
    noise = _reference_noise(ref, TRAIN["steps"])
    ref_out = ref.fit()

    port = PrivacySession.from_config(
        get_config(arch).reduced(**over),
        DPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        TrainConfig(**TRAIN), device="cpu",
        params=params_from_numpy(p0, "cpu"))
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
