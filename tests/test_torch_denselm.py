"""The port's dense decoder LM (``models/transformer.py`` ``DenseLM`` and
its pieces in ``models/common.py``) against the reference's, with the
reference's weights carried over by ``params_from_numpy`` and tokens made
from a numpy seed.

Tolerances (the two sides use different matmul and reduction stacks, and
``cos``/``sin``/``exp``/``silu`` differ by ULPs):
* f32 (the reduced configs): per-example losses within 2e-5; per-example
  grads within 2e-5 of the largest gradient entry; squared norms within
  2e-5 relative (measured 9.5e-7, 1.3e-6 and 4.2e-7 over the five
  configs).
* bf16 activations (the full configs' dtype, at reduced width): losses
  within 2e-2, grads within 5e-2 of the largest entry and squared norms
  within 5e-2 relative (measured 3.0e-3, 1.4e-2 and 4.9e-3): bf16 keeps 8
  bits, and a value rounded on one side of a bf16 tie can round the other
  way on the other side.  The ViT's bounds (test_torch_vit.py).
* The pieces alone, f32: ``apply_rope`` 1e-6 absolute on O(1) inputs (the
  angles' ``cos``/``sin`` differ by ULPs at positions up to 64);
  ``rmsnorm`` 1e-6; ``_sdpa`` and ``self_attention`` 1e-6 of the largest
  output (f32 products and softmax in another order).  bf16: one bf16 step
  of the output, 2**-7 relative to its largest entry.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen3_1_7b import SLIDING as REF_SWA
from repro.core.clipping import per_example_grads_and_sq as ref_pe
from repro.core.tape import Tape as RefTape
from repro.models import common as ref_cm
from repro.models.registry import build as ref_build
from repro.models.registry import get_config as ref_get_config
from repro_torch.configs import get_config
from repro_torch.configs.qwen3_1_7b import SLIDING
from repro_torch.core.clipping import per_example_grads_and_sq
from repro_torch.core.tape import Tape
from repro_torch.models import build
from repro_torch.models import common as cm
from repro_torch.utils.params import flatten_tree, params_from_numpy

ARCHS = ["qwen2-0.5b", "qwen3-1.7b", "qwen3-1.7b-swa", "llama3.2-3b",
         "deepseek-67b"]
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 5e-2)}
B, T = 3, 24          # T > the reduced sliding window of 16


def _configs(name, dtype):
    if name == "qwen3-1.7b-swa":
        return REF_SWA.reduced(dtype=dtype), SLIDING.reduced(dtype=dtype)
    return (ref_get_config(name).reduced(dtype=dtype),
            get_config(name).reduced(dtype=dtype))


@functools.lru_cache(maxsize=None)
def _pair(name, dtype):
    rcfg, cfg = _configs(name, dtype)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, T + 1)).astype(
        np.int32)
    rbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    return rmodel, rparams, rbatch, model, params, batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
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
    assert list(want) == sorted(grads, key=lambda s: s.split("."))
    scale = max(float(np.abs(v).max()) for v in want.values())
    for path, w in want.items():
        assert grads[path].shape == w.shape, path
        np.testing.assert_allclose(grads[path].numpy(), w, rtol=0,
                                   atol=TOL[dtype][1] * scale, err_msg=path)
    np.testing.assert_allclose(sq.numpy(), np.asarray(rsq),
                               rtol=TOL[dtype][1])


def test_logits_match_reference():
    rmodel, rparams, rbatch, model, params, batch = _pair("qwen2-0.5b",
                                                          "float32")
    want = np.asarray(rmodel.logits(rparams, rbatch["tokens"], RefTape()))
    model = build(model.cfg, device="cpu")
    model.load_state_dict(params)
    got = model.logits(batch["tokens"])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-5)


def _rng_array(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_and_rmsnorm_match_reference(dtype):
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    x = _rng_array((2, 64, 3, 16), 1)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    want = np.asarray(ref_cm.apply_rope(jnp.asarray(x, dtype),
                                        jnp.asarray(pos), 1e6)
                      .astype(jnp.float32))
    got = cm.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(pos.copy()), 1e6).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))
    g = _rng_array((16,), 2)
    want = np.asarray(ref_cm.rmsnorm(RefTape(), "n", jnp.asarray(x, dtype),
                                     {"w": jnp.asarray(g)}, path="n")
                      .astype(jnp.float32))
    got = cm.rmsnorm(Tape(), "n", torch.from_numpy(x).to(
        getattr(torch, dtype)), {"w": torch.from_numpy(g)},
        path="n").float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["causal", "window", "batched"])
def test_sdpa_gqa_matches_reference(mask, dtype):
    """GQA (2 KV heads, 3 query heads each) with the causal mask, the
    sliding-window mask (window 5) and a per-example (B, T, S) mask."""
    Tq = 12
    q = _rng_array((2, Tq, 2, 3, 8), 3)
    k = _rng_array((2, Tq, 2, 8), 4)
    v = _rng_array((2, Tq, 2, 8), 5)
    ti, si = np.arange(Tq)[:, None], np.arange(Tq)[None, :]
    m = si <= ti
    if mask == "window":
        m = m & (si > ti - 5)
    if mask == "batched":
        m = np.stack([m, np.random.default_rng(6).random((Tq, Tq)) < 0.7])
        m[:, :, 0] = True
    jt = getattr(jnp, dtype)
    want = np.asarray(ref_cm._sdpa(jnp.asarray(q, jt), jnp.asarray(k, jt),
                                   jnp.asarray(v, jt), jnp.asarray(m))
                      .astype(jnp.float32))
    tt = getattr(torch, dtype)
    got = cm._sdpa(torch.from_numpy(q).to(tt), torch.from_numpy(k).to(tt),
                   torch.from_numpy(v).to(tt), torch.from_numpy(m))
    assert got.dtype == tt
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


ATTN_VARIANTS = {
    "causal_bias": dict(qkv_bias=True),
    "window_qknorm": dict(qk_norm=True, window=5),
    "bidirectional_norope": dict(causal=False, use_rope=False),
}


@pytest.mark.parametrize("variant", sorted(ATTN_VARIANTS))
def test_self_attention_matches_reference(variant):
    """The training branch of the reference's ``attention`` on its own, f32:
    GQA (4 heads on 2 KV heads), RoPE at θ 1e6, and each mask."""
    kw = ATTN_VARIANTS[variant]
    rcfg = ref_cm.AttnCfg(n_heads=4, n_kv_heads=2, head_dim=8,
                          rope_theta=1e6, **kw)
    cfg = cm.AttnCfg(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=1e6,
                     **kw)
    rng = np.random.default_rng(8)
    tree = {nm: {"w": (rng.standard_normal(shape) * 0.3).astype(np.float32)}
            for nm, shape in (("wq", (16, 32)), ("wk", (16, 16)),
                              ("wv", (16, 16)), ("wo", (32, 16)))}
    if cfg.qkv_bias:
        for nm, n in (("wq", 32), ("wk", 16), ("wv", 16)):
            tree[nm]["b"] = rng.standard_normal(n).astype(np.float32)
    if cfg.qk_norm:
        tree["qn"] = {"w": rng.random(8).astype(np.float32) + 0.5}
        tree["kn"] = {"w": rng.random(8).astype(np.float32) + 0.5}
    x = _rng_array((2, 12, 16), 9)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want, _ = ref_cm.attention(RefTape(), "attn", "attn",
                               jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x), rcfg,
                               positions=jnp.asarray(pos))
    got = cm.self_attention(Tape(), "attn", "attn",
                            params_from_numpy(tree, "cpu"),
                            torch.from_numpy(x), cfg,
                            positions=torch.from_numpy(pos))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def test_attention_at_flash_length_raises():
    """The reference takes flash attention from FLASH_MIN_T tokens on; the
    port has none and refuses instead of approximating."""
    a = cm.AttnCfg(n_heads=2, n_kv_heads=1, head_dim=4)
    x = torch.zeros(1, cm.FLASH_MIN_T, 8)
    with pytest.raises(NotImplementedError, match="FLASH_MIN_T"):
        cm.self_attention(Tape(), "attn", "attn", {}, x, a)
    assert cm.FLASH_MIN_T == ref_cm.FLASH_MIN_T
