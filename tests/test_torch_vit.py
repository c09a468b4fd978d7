"""The port's ViT against the reference's, with the reference's weights
carried over by ``params_from_numpy`` and inputs made from a seed.

Tolerances (the two sides use different matmul and reduction stacks):
* f32 (the reduced config): per-example losses within 2e-5; per-example
  grads within 2e-5 of the largest gradient entry; squared norms within
  2e-5 relative.
* bf16 activations (the full config's dtype, at reduced width): losses
  within 2e-2 and grads within 5e-2 of the largest entry — bf16 keeps 8
  bits, and a product rounded on one side of a bf16 tie can round the
  other way on the other side.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vit_base import CONFIG as REF_VIT
from repro.core.clipping import per_example_grads_and_sq as ref_pe
from repro.core.tape import Tape as RefTape
from repro.models.registry import build as ref_build
from repro_torch.configs import get_config
from repro_torch.core.clipping import per_example_grads_and_sq
from repro_torch.core.tape import Tape
from repro_torch.models import build
from repro_torch.models.common import per_example_ce_single
from repro_torch.utils.params import flatten_tree, params_from_numpy

TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 5e-2)}


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    rmodel = ref_build(REF_VIT.reduced(dtype=dtype))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build(get_config("vit-base").reduced(dtype=dtype), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 100, 5).astype(np.int32)
    return (rmodel, rparams, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
            model, params, {"image": torch.from_numpy(x),
                            "label": torch.from_numpy(y)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_example_losses_match_reference(dtype):
    rmodel, rparams, rbatch, model, params, batch = _pair(dtype)
    want = np.asarray(jax.jit(lambda p, b: rmodel.loss(p, b, RefTape()))(
        rparams, rbatch))
    got = model.loss(params, batch).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_example_grads_match_reference(dtype):
    rmodel, rparams, rbatch, model, params, batch = _pair(dtype)
    rgrads, rsq = jax.jit(lambda p, b: ref_pe(
        lambda pp, bb, t: rmodel.loss(pp, bb, t), p, b))(rparams, rbatch)
    grads, sq = per_example_grads_and_sq(model.loss, params, batch)
    want = flatten_tree(jax.tree.map(np.asarray, rgrads))
    assert list(want) == sorted(grads, key=lambda s: s.split("."))
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        assert grads[name].shape == w.shape, name
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=0,
                                   atol=TOL[dtype][1] * scale,
                                   err_msg=name)
    np.testing.assert_allclose(sq.numpy(), np.asarray(rsq),
                               rtol=TOL[dtype][1])


def test_patchify_is_nhwc_with_the_reference_transpose():
    model = build(get_config("vit-base").reduced(), device="cpu")
    img = torch.arange(2 * 32 * 32 * 3, dtype=torch.float32).reshape(
        2, 32, 32, 3)
    rmodel = ref_build(REF_VIT.reduced())
    want = np.asarray(rmodel._patchify(jnp.asarray(img.numpy())))
    np.testing.assert_array_equal(model._patchify(img).numpy(), want)


def _untaped_forward(model, params, images):
    """The ViT forward as it was before the tape was threaded through it,
    op for op: plain mode must keep its arithmetic bit for bit."""
    cfg, dt = model.cfg, model.cfg.act_dtype

    def dense(x, w, b=None):
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
        return y if b is None else y + b.to(y.dtype)

    def layernorm(x, g, b):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        h = ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype) * g.to(x.dtype)
        return h + b.to(h.dtype)

    x = dense(model._patchify(images.to(dt)), params["patch.w"],
              params["patch.b"])
    B, H, hd = x.shape[0], cfg.n_heads, cfg.hd
    cls = x.new_zeros(B, 1, cfg.d_model) + params["cls.w"].to(dt)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos.w"].to(x.dtype)
    blocks = {k[len("blocks."):]: v.unbind(0) for k, v in params.items()
              if k.startswith("blocks.")}
    for layer in range(cfg.n_layers):
        p = {k: v[layer] for k, v in blocks.items()}
        h = layernorm(x, p["ln1.g.w"], p["ln1.b.w"])
        T = h.shape[1]
        q, k, v = (dense(h, p[f"attn.{n}.w"], p[f"attn.{n}.b"]).reshape(
            B, T, H, hd) for n in ("wq", "wk", "wv"))
        scale = torch.tensor(hd ** -0.5, dtype=q.dtype)
        s = torch.einsum("bthd,bshd->bhts", (q * scale).float(), k.float())
        o = torch.einsum("bhts,bshd->bthd",
                         torch.softmax(s, dim=-1).to(v.dtype).float(),
                         v.float()).to(v.dtype)
        x = x + dense(o.reshape(B, T, H * hd), p["attn.wo.w"])
        h = layernorm(x, p["ln2.g.w"], p["ln2.b.w"])
        h = dense(h, p["mlp.w1.w"], p["mlp.w1.b"])
        h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
        x = x + dense(h, p["mlp.w2.w"], p["mlp.w2.b"])
    x = layernorm(x, params["lnf.g.w"], params["lnf.b.w"])
    return dense(x[:, 0], params["head.w"], params["head.b"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_is_unchanged_by_the_tape(dtype):
    """BITWISE: the taped forward in plain mode (and in record mode, which
    adds zero eps) gives the untaped forward's losses, and plain mode its
    gradients."""
    _, _, _, model, params, batch = _pair(dtype)

    def untaped(p):
        return per_example_ce_single(_untaped_forward(model, p,
                                                      batch["image"]),
                                     batch["label"])
    want = untaped(params)
    assert torch.equal(model.loss(params, batch), want)
    assert torch.equal(model.loss(params, batch, Tape()), want)
    assert torch.equal(model.loss(params, batch, Tape(Tape.RECORD)), want)
    g_want = torch.func.grad(lambda p: untaped(p).sum())(params)
    g_got = torch.func.grad(lambda p: model.loss(p, batch).sum())(params)
    for name in params:
        assert torch.equal(g_got[name], g_want[name]), name
