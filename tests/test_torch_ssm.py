"""The port's SSM and hybrid families (``models/mamba2.py``,
``models/zamba2.py``) against the reference's, with the reference's weights
carried over by ``params_from_numpy`` and inputs made from a numpy seed.

Models: reduced mamba2-1.3b (2 layers, d 128, 8 SSM heads of 32, state
16, chunk 8), reduced zamba2-1.2b (``attn_every`` 1: 2 supers of one mamba
layer, no tail) and a narrow hybrid (``attn_every`` 2 and 5 layers: 2
supers of 2 and a tail of 1, so the ``supers.inner`` stacks nest and
``tailb`` exists).

Tolerances:
* ``ssd_chunked`` and ``ssd_step`` against the reference's, f32: 2e-5 of
  the largest output (other contraction orders and ``exp``/``cumsum``
  ULPs; measured about 1e-7).  Chunk invariance and the chunked scan
  against the per-token recurrence: the reference's own bounds (rtol 2e-4,
  atol 2e-5, tests/test_flashattn.py).
* per-example losses, grads and squared norms: f32 2e-5 (grads of the
  largest entry; norms relative; measured up to 3.2e-6 on the narrow
  hybrid); bf16 on the two reduced configs at DenseLM's bounds (2e-2,
  5e-2, 5e-2; measured 1.0e-2, 2.4e-2 and 3.4e-3 on zamba2).  The narrow
  hybrid's bf16 embedding grad differs from the reference's by 5.1e-2 of
  the largest entry (seeds 1 and 2: 3.9e-2, 3.0e-2), as far as either
  side's bf16 grad lies from its own f32 one (the port 5.4e-2, 3.8e-2,
  3.4e-2; the reference 4.3e-2, 4.0e-2, 3.8e-2), and about as far as the
  reference's own bf16 grad moves when every weight is scaled by
  1 + 2^-20 (4.5e-2, 2.2e-2, 2.2e-2); the reduced configs show the same
  ratios.  So it is held in bf16 by that witness
  (``test_hybrid_bf16_gap_is_the_references_own_rounding``), every other
  leaf at DenseLM's bound.
* configs, names, leaf order, flat offsets and token streams: exact.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clipping import per_example_grads_and_sq as ref_pe
from repro.core.tape import Tape as RefTape
from repro.data.synthetic import dataset_for_config as ref_dataset
from repro.models import mamba2 as ref_mamba2
from repro.models import registry as ref_registry
from repro.utils.params import FlatGradView as RefView
from repro_torch.configs import get_config
from repro_torch.core.clipping import per_example_grads_and_sq
from repro_torch.data import TokenDataset, dataset_for_config
from repro_torch.models import Mamba2LM, Zamba2LM, build
from repro_torch.models.mamba2 import ssd_chunked, ssd_step
from repro_torch.utils.params import (FlatGradView, flatten_tree,
                                      params_from_numpy)

SSM = ["mamba2-1.3b", "zamba2-1.2b"]
# name -> (arch, overrides of reduced())
MODELS = {"mamba2": ("mamba2-1.3b", {}),
          "zamba2": ("zamba2-1.2b", {}),
          "hybrid5": ("zamba2-1.2b", dict(attn_every=2, n_layers=5))}
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 5e-2)}
SSD_RTOL, SSD_ATOL = 2e-4, 2e-5
B, T = 3, 32


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
def _ref_init(name):
    """The reference's f32 parameters of ``name`` (the same for every
    activation dtype), initialised under ``jit`` (one compile, not one
    dispatch per op)."""
    arch, over = MODELS[name]
    rmodel = ref_registry.build(ref_registry.get_config(arch).reduced(**over))
    return jax.jit(rmodel.init)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pair(name, dtype="float32"):
    arch, over = MODELS[name]
    rcfg = ref_registry.get_config(arch).reduced(dtype=dtype, **over)
    cfg = get_config(arch).reduced(dtype=dtype, **over)
    rmodel = ref_registry.build(rcfg)
    rparams = _ref_init(name)
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, T + 1)).astype(
        np.int32)
    rbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    return rmodel, rparams, rbatch, model, params, batch


def _ssd_inputs(seed, b=2, t=32, h=3, p=4, n=8):
    """The reference test's input recipe, from a numpy seed: dt from a
    softplus, u = -|N(0,1)| dt."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    u = (-np.abs(rng.standard_normal((b, t, h))) * dt).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    return x, dt, u, bm, cm


# ---------------------------------------------------------------------------
# configs, registry, data, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SSM)
def test_configs_match_reference(name):
    port, ref = get_config(name), ref_registry.get_config(name)
    over = dict(attn_every=2, n_layers=5) if ref.family == "hybrid" else {}
    for cfg, rcfg in ((port, ref), (port.reduced(), ref.reduced()),
                      (port.reduced(**over), ref.reduced(**over))):
        for f in dataclasses.fields(rcfg):
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
        assert (cfg.d_inner, cfg.nheads_ssm, cfg.hd) == (
            rcfg.d_inner, rcfg.nheads_ssm, rcfg.hd)


@pytest.mark.parametrize("name,cls", [("mamba2-1.3b", Mamba2LM),
                                      ("zamba2-1.2b", Zamba2LM)])
def test_registry_builds_the_family(name, cls):
    assert isinstance(build(get_config(name).reduced(), device="cpu"), cls)


@pytest.mark.parametrize("name", SSM)
def test_token_dataset_matches_reference(name):
    ds = dataset_for_config(get_config(name), 20, 17, seed=5)
    ref = ref_dataset(ref_registry.get_config(name), 20, 17, seed=5)
    assert isinstance(ds, TokenDataset)
    idx = np.array([3, 0, 19])
    got, want = ds.fetch(idx), ref.fetch(idx)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_weights_carry_over_in_flatten_order(name):
    """The port model's own leaves are the reference's, by name, order and
    shape (the (n_super, attn_every, ...) leaves and ``tailb`` included),
    and FlatGradView puts every reference leaf at the reference's offset."""
    _, rparams, _, model, params, _ = _pair(name)
    leaves, _ = jax.tree_util.tree_flatten_with_path(rparams)
    names = [".".join(k.key for k in path) for path, _ in leaves]
    own = model.params()
    assert list(params) == list(own) == names
    assert [tuple(v.shape) for v in own.values()] == [
        tuple(v.shape) for _, v in leaves]
    view, rview = FlatGradView.for_params(params), RefView.for_tree(rparams)
    assert (view.names, view.offsets, view.sizes, view.total) == (
        tuple(names), rview.offsets, rview.sizes, rview.total)
    np.testing.assert_array_equal(view.flatten(params).numpy(),
                                  np.asarray(rview.flatten(rparams)))
    if name == "hybrid5":
        assert own["supers.inner.mamba.in_proj.w"].shape[:2] == (2, 2)
        assert own["tailb.mamba.a_neg.w"].shape[0] == 1


@pytest.mark.parametrize("name", SSM)
def test_full_width_parameter_counts(name, monkeypatch):
    """The full configs' leaf shapes and counts against the reference's
    tree, neither materialised (the port's model on the meta device, its
    draws from a CPU generator): mamba2-1.3b 1,446,505,472 params,
    zamba2-1.2b 1,170,313,344."""
    rmodel = ref_registry.build(ref_registry.get_config(name))
    shapes = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
    class CPUGenerator(torch.Generator):
        def __new__(cls, device=None):
            return super().__new__(cls)

        def __init__(self, device=None):
            super().__init__()

    monkeypatch.setattr(torch, "Generator", CPUGenerator)
    model = build(get_config(name), device="meta")
    got = {k: tuple(v.shape) for k, v in model.params().items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == {
        "mamba2-1.3b": 1_446_505_472, "zamba2-1.2b": 1_170_313_344}[name]


def test_initialisation_follows_the_reference_distributions():
    p = build(get_config("mamba2-1.3b").reduced(), device="cpu",
              seed=3).params()
    a = p["blocks.mamba.a_neg.w"]
    assert bool(((a <= -1.0) & (a >= -16.0)).all())
    assert float(a.max() - a.min()) > 1.0          # a spread of decays
    assert bool((p["blocks.mamba.D.w"] == 1).all())
    assert bool((p["blocks.mamba.dt_bias.w"] == 0).all())
    assert bool((p["blocks.mamba.ssm_norm.w"] == 1).all())
    assert 0.15 < float(p["blocks.mamba.conv.w"].std()) < 0.25


# ---------------------------------------------------------------------------
# the SSD core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_reference(chunk, init):
    x, dt, u, bm, cm = _ssd_inputs(1)
    s0 = (np.random.default_rng(2).standard_normal((2, 3, 8, 4)).astype(
        np.float32) if init else None)
    ry, rs = ref_mamba2.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, u, bm, cm)), chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    y, s = ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, u, bm, cm)),
                       chunk, init_state=None if s0 is None
                       else torch.from_numpy(s0))
    for got, want in ((y, ry), (s, rs)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-5 * float(np.abs(want).max()))


def test_ssd_chunk_invariance_and_recurrence():
    """The chunked scan is exact: chunk 8 against chunk 32 and against the
    per-token ``ssd_step`` loop, at the reference's bounds; ``ssd_step``
    against the reference's at 2e-5 of its largest output."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(3)]
    y8, s8 = ssd_chunked(*args, 8)
    y32, s32 = ssd_chunked(*args, 32)
    np.testing.assert_allclose(y8.numpy(), y32.numpy(), rtol=SSD_RTOL,
                               atol=SSD_ATOL)
    np.testing.assert_allclose(s8.numpy(), s32.numpy(), rtol=SSD_RTOL,
                               atol=SSD_ATOL)
    state = torch.zeros(2, 3, 8, 4)
    rstate = jnp.zeros((2, 3, 8, 4))
    for t in range(args[0].shape[1]):
        step_in = [a[:, t] for a in args]
        yt, state = ssd_step(state, *step_in)
        ryt, rstate = ref_mamba2.ssd_step(
            rstate, *(jnp.asarray(a.numpy()) for a in step_in))
        np.testing.assert_allclose(yt.numpy(), y8[:, t].numpy(),
                                   rtol=SSD_RTOL, atol=SSD_ATOL)
        np.testing.assert_allclose(yt.numpy(), np.asarray(ryt), rtol=0,
                                   atol=2e-5 * float(np.abs(ryt).max()))
    np.testing.assert_allclose(state.numpy(), s8.numpy(), rtol=SSD_RTOL,
                               atol=SSD_ATOL)


def test_ssd_under_vmap_and_grad():
    """The chunk loop batches under ``torch.func.vmap(grad)`` (the
    per-example engines' path) and equals the batched gradient row for
    row, with no NaN from the masked ``exp``."""
    x, dt, u, bm, cm = (torch.from_numpy(a) for a in _ssd_inputs(4))

    def f(xx, d, uu, b_, c_):
        y, s = ssd_chunked(xx[None], d[None], uu[None], b_[None], c_[None], 8)
        return (y.square().sum() + s.sum())

    g = torch.func.vmap(torch.func.grad(f, argnums=(0, 2)))(x, dt, u, bm, cm)
    xr, ur = x.clone().requires_grad_(), u.clone().requires_grad_()
    y, s = ssd_chunked(xr, dt, ur, bm, cm, 8)
    (y.square().sum() + s.sum()).backward()
    for got, want in zip(g, (xr.grad, ur.grad)):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype", [
    *((n, "float32") for n in sorted(MODELS)),
    ("mamba2", "bfloat16"), ("zamba2", "bfloat16")])
def test_per_example_losses_and_grads_match_reference(name, dtype):
    rmodel, rparams, rbatch, model, params, batch = _pair(name, dtype)
    want_l = np.asarray(jax.jit(lambda p, b: rmodel.loss(p, b, RefTape()))(
        rparams, rbatch))
    np.testing.assert_allclose(model.loss(params, batch).numpy(), want_l,
                               rtol=0, atol=TOL[dtype][0])
    rgrads, rsq = jax.jit(lambda p, b: ref_pe(
        lambda pp, bb, t: rmodel.loss(pp, bb, t), p, b))(rparams, rbatch)
    grads, sq = per_example_grads_and_sq(model.loss, params, batch)
    want = flatten_tree(jax.tree.map(np.asarray, rgrads))
    assert set(want) == set(grads)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for path, w in want.items():
        assert grads[path].shape == w.shape, path
        np.testing.assert_allclose(grads[path].numpy(), w, rtol=0,
                                   atol=TOL[dtype][1] * scale, err_msg=path)
    np.testing.assert_allclose(sq.numpy(), np.asarray(rsq),
                               rtol=TOL[dtype][1])


def test_hybrid_bf16_gap_is_the_references_own_rounding():
    """The narrow hybrid in bf16: losses and squared norms at DenseLM's
    bf16 bounds, every grad leaf but the embedding's at 5e-2 of the largest
    entry, and the embedding grad, the one leaf past that bound, no further
    from the reference's than twice what the reference's own bf16 grad
    moves when every weight is scaled by 1 + 2^-20 (far below one bf16
    step: it only moves rounding ties).  Measured: 5.1e-2 against a move
    of 4.5e-2; the other leaves within 3.2e-3."""
    rmodel, rparams, rbatch, model, params, batch = _pair("hybrid5",
                                                          "bfloat16")
    rloss = jax.jit(lambda p, b: rmodel.loss(p, b, RefTape()))
    np.testing.assert_allclose(model.loss(params, batch).numpy(),
                               np.asarray(rloss(rparams, rbatch)), rtol=0,
                               atol=TOL["bfloat16"][0])
    ref = jax.jit(lambda p, b: ref_pe(
        lambda pp, bb, t: rmodel.loss(pp, bb, t), p, b))
    rgrads, rsq = ref(rparams, rbatch)
    moved, _ = ref(jax.tree.map(lambda x: x * (1 + 2.0 ** -20), rparams),
                   rbatch)
    want = flatten_tree(jax.tree.map(np.asarray, rgrads))
    moved = flatten_tree(jax.tree.map(np.asarray, moved))
    grads, sq = per_example_grads_and_sq(model.loss, params, batch)
    np.testing.assert_allclose(sq.numpy(), np.asarray(rsq),
                               rtol=TOL["bfloat16"][1])
    scale = max(float(np.abs(v).max()) for v in want.values())
    for path, w in want.items():
        if path != "emb.w":
            np.testing.assert_allclose(
                grads[path].numpy(), w, rtol=0,
                atol=TOL["bfloat16"][1] * scale, err_msg=path)
    gap = float(np.abs(grads["emb.w"].numpy() - want["emb.w"]).max())
    own = float(np.abs(moved["emb.w"] - want["emb.w"]).max())
    assert 0 < gap <= 2 * own, (gap / scale, own / scale)


@pytest.mark.parametrize("name", ["mamba2", "hybrid5"])
def test_logits_match_reference(name):
    rmodel, rparams, rbatch, model, params, batch = _pair(name)
    want = np.asarray(rmodel.logits(rparams, rbatch["tokens"], RefTape()))
    fresh = build(model.cfg, device="cpu")
    fresh.load_state_dict(params)
    got = fresh.logits(batch["tokens"]).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_cli_trains_mamba2(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                      "--seq-len", "16", "--steps", "1", "--n-data", "16",
                      "--physical", "4", "--q", "0.25", "--engine",
                      "masked_bk", "--describe"])
    assert out["history"] and np.isfinite(out["history"][0]["loss"])
    described = json.loads(capsys.readouterr().out.splitlines()[0])
    assert described["arch"] == "mamba2-1.3b-smoke"
