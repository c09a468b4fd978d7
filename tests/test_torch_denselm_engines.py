"""The clipping engines on the port's dense decoder LM against the
reference's, with the reference's weights and tokens made from a numpy
seed.

At the reduced width (d 128, 4 heads, 2 KV heads, head_dim 32, d_ff 256,
vocab 97) and T = 128, the Mixed-Ghost rule (direct when T² > din·dout)
sends ``wk``, ``wv`` (128 x 64) and the head (128 x 97) to the direct path
(the ``ghost_norm_dense`` wrapper) and ``wq``, ``wo`` (128 x 128) and the
SwiGLU denses (128 x 256, 256 x 128) to the Gram path, so both paths run
in one block, as on full-width qwen2-0.5b at 1,024 tokens.

Tolerances (f32):
* every engine's clipped sum (``masked_pe``, ``masked_fused``,
  ``masked_fused_stream`` at a tile of 4 below the batch of 6,
  ``masked_ghost``, ``masked_bk``) against the reference's: 2e-5 of the
  largest entry; norms 2e-5 relative; clip coefficients 2e-5 absolute.  The
  ViT's bounds (test_torch_ghost.py; measured up to 1.2e-6 here).
* the chunked head (``ce_chunk`` 8 at T = 32): losses 2e-5 absolute, ghost
  norms 2e-5 relative, the ``masked_bk`` sum 2e-5 of the largest entry.
* ``embed`` at qwen2-0.5b's vocab of 151,936: norms 1e-5 relative, BK
  grads 1e-5 of the largest entry (test_torch_ghost.py's companion bounds).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clipping as ref_clipping
from repro.core import layers as ref_layers
from repro.core.tape import LayerSpec as RefSpec
from repro.core.tape import Tape as RefTape
from repro.models.registry import build as ref_build
from repro.models.registry import get_config as ref_get_config
from repro_torch.configs import get_config
from repro_torch.core import clipping
from repro_torch.core import layers as L
from repro_torch.core.tape import LayerSpec
from repro_torch.kernels import ghost_norm as gn
from repro_torch.models import build
from repro_torch.utils.params import flatten_tree, params_from_numpy

B = 6
MASK = np.array([1, 1, 0, 1, 1, 1], np.float32)
ENGINES = ["masked_pe", "masked_fused", "masked_fused_stream",
           "masked_ghost", "masked_bk"]


@functools.lru_cache(maxsize=None)
def _lm(T=128, **over):
    rmodel = ref_build(ref_get_config("qwen2-0.5b").reduced(**over))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build(get_config("qwen2-0.5b").reduced(**over), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab, (B, T + 1)).astype(np.int32)
    return (lambda p, b, t: rmodel.loss(p, b, t), rparams,
            {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            model.loss, params,
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


def _ref_ghost_norms(rloss, rparams, rbatch):
    """The reference's ghost norms, jitted as its step builders run them."""
    return jax.jit(lambda p, b: ref_clipping.ghost_norms(rloss, p, b))(
        rparams, rbatch)


def _hold(got, rsum, tol=2e-5):
    want = flatten_tree(jax.tree.map(np.asarray, rsum))
    assert set(want) == set(got)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=tol * scale, err_msg=name)


def test_both_norm_paths_run_at_t128(monkeypatch):
    """The direct path takes wk, wv and the head, through the kernel's
    wrapper (one call per layer and per dense); the ghost norms still match
    the reference's."""
    rloss, rparams, rbatch, loss, params, batch = _lm()
    calls = []
    monkeypatch.setattr(L, "ghost_norm_dense",
                        lambda x, d: calls.append((x.shape[2], d.shape[2]))
                        or gn.ghost_norm_dense(x, d))
    sq, _ = clipping.ghost_norms(loss, params, batch)
    assert sorted(calls) == sorted([(128, 64)] * 4 + [(128, 97)])
    want, _ = _ref_ghost_norms(rloss, rparams, rbatch)
    np.testing.assert_allclose(sq.numpy(), np.asarray(want), rtol=2e-5)


@pytest.mark.parametrize("engine", ENGINES)
def test_engines_match_reference(engine):
    rloss, rparams, rbatch, loss, params, batch = _lm()
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


def test_tape_records_in_reference_order_and_projections_share_h():
    """Specs in the tape's insertion order with the reference's kinds,
    stacks and parameter paths; a layer's wq, wk and wv records hold the
    one tensor ``h`` (the post-norm input), not three copies."""
    rloss, rparams, rbatch, loss, params, batch = _lm(T=16)
    rtape = RefTape(RefTape.COLLECT)
    jax.eval_shape(lambda p, b: rloss(p, b, rtape), rparams, rbatch)
    dEps, records, specs, _ = clipping._eps_backward(loss, params, batch)
    assert list(specs) == list(rtape.specs)
    for name, spec in specs.items():
        rs = rtape.specs[name]
        assert (spec.kind, spec.stack, spec.param_path, spec.meta) == (
            rs.kind, rs.stack, rs.param_path, rs.meta), name
        dy = torch.stack(dEps[name]) if spec.stack else dEps[name]
        assert tuple(dy.shape) == rtape.eps[name].shape, name
    for q, k, v in zip(records["blocks/attn.wq"]["x"],
                       records["blocks/attn.wk"]["x"],
                       records["blocks/attn.wv"]["x"]):
        assert q.data_ptr() == k.data_ptr() == v.data_ptr()


def test_chunked_head_matches_reference():
    """``ce_chunk`` 8 at T = 32: the head runs per chunk as
    ``cechunks/shared/head``, folded as 'uses'; the loss, the ghost norms
    and the masked_bk sum match the reference's."""
    rloss, rparams, rbatch, loss, params, batch = _lm(T=32, ce_chunk=8)
    np.testing.assert_allclose(
        loss(params, batch).numpy(),
        np.asarray(jax.jit(lambda p, b: rloss(p, b, RefTape()))(rparams,
                                                                 rbatch)),
        rtol=0, atol=2e-5)
    _, records, specs, _ = clipping._eps_backward(loss, params, batch)
    assert specs["cechunks/shared/head"].stack == ("uses",)
    assert "head" not in specs
    assert len(records["cechunks/shared/head"]["x"]) == 4
    sq, _ = clipping.ghost_norms(loss, params, batch)
    want, _ = _ref_ghost_norms(rloss, rparams, rbatch)
    np.testing.assert_allclose(sq.numpy(), np.asarray(want), rtol=2e-5)
    rsum, _ = jax.jit(lambda p, b, m: ref_clipping.ENGINES["masked_bk"](
        rloss, p, b, m, 1.0))(rparams, rbatch, jnp.asarray(MASK))
    tsum, _ = clipping.resolve_engine("masked_bk")(
        loss, params, batch, torch.from_numpy(MASK), 1.0,
        check_coverage=True)
    _hold(tsum, rsum)


def test_embed_companions_at_full_vocab():
    """qwen2-0.5b's embedding (vocab 151,936) at a narrow width: the ghost
    norm over the one-hot design and the BK grad's scatter into the full
    table."""
    rng = np.random.default_rng(7)
    vocab = get_config("qwen2-0.5b").vocab
    ids = rng.integers(0, vocab, (3, 16)).astype(np.int32)
    ids[0, 5] = ids[0, 9]                 # a repeated token in one example
    dy = rng.standard_normal((3, 16, 8)).astype(np.float32)
    coef = np.array([0.5, 0.0, 1.0], np.float32)
    meta = (("vocab", vocab),)
    want = ref_layers.per_example_sq_norm(
        RefSpec("embed", param_path="emb.w", meta=meta),
        {"ids": jnp.asarray(ids)}, jnp.asarray(dy))
    spec = LayerSpec("embed", param_path="emb.w", meta=meta)
    got = L.per_example_sq_norm(spec, {"ids": torch.from_numpy(ids)},
                                torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    rbk = ref_layers.bk_grads(
        RefSpec("embed", param_path="emb.w", meta=meta),
        {"ids": jnp.asarray(ids)}, jnp.asarray(dy), jnp.asarray(coef))
    tbk = L.bk_grads(spec, {"ids": torch.from_numpy(ids)},
                     torch.from_numpy(dy), torch.from_numpy(coef))
    w = np.asarray(rbk["emb.w"])
    assert tbk["emb.w"].shape == (vocab, 8)
    np.testing.assert_allclose(tbk["emb.w"].numpy(), w, rtol=0,
                               atol=1e-5 * float(np.abs(w).max()))
