"""The resident ``clip_accum`` kernel's plain version and the
``masked_fused`` engine, and the ``"ghost"`` norm source of
``masked_fused_stream``, against the reference and against the port's own
``masked_pe``, on inputs made from a seed with numpy.

Tolerances:
* ``clip_accum`` plain version vs ``clip_accum_ref`` and vs the reference's
  kernel in interpret mode: BITWISE, f32 and bf16 — all fold strictly left
  from +0 with one rounding per op.
* ``masked_fused`` vs the port's ``masked_pe``: BITWISE — the same
  per-example grads (``vmap(grad)`` at the whole batch), the same
  coefficients and the same fold.  Against the reference's
  ``masked_fused``: 2e-5 of the largest entry, as ``masked_pe``.
* ``masked_fused_stream`` with the ``"ghost"`` norm source: its norms and
  coefficients bitwise equal to ``masked_ghost``'s when the tile is the
  whole batch (the same ghost pass on the same batch); its sum 1e-5 of the
  largest entry from ``masked_pe`` (measured in the f32 reduced ViT; the
  ghost norms differ from the per-example ones at f32 rounding) and 2e-5
  from the reference's streaming engine under the same source.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vit_base import CONFIG as REF_VIT
from repro.core import clipping as ref_clipping
from repro.core import fused as ref_fused
from repro.kernels.clip_accum import clip_accum as ref_clip_accum
from repro.kernels.ref import clip_accum_ref
from repro.models.registry import build as ref_build
from repro_torch.configs import get_config
from repro_torch.core import clipping, fused
from repro_torch.kernels import clip_accum as ca
from repro_torch.models import build
from repro_torch.utils.params import (FlatGradView, flatten_tree,
                                      params_from_numpy)

B = 6
MASK = np.array([1, 1, 0, 1, 1, 1], np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.int32)


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_accum_plain_bitwise_vs_reference(m, dtype):
    rng = np.random.default_rng(m)
    d = 1536
    g = rng.standard_normal((m, d)).astype(np.float32)
    norms = (np.abs(rng.standard_normal(m)) * 3).astype(np.float32)
    norms[0] = 0.0                                 # the 1e-12 floor
    mask = (rng.random(m) > 0.3).astype(np.float32)
    gj = jnp.asarray(g, getattr(jnp, dtype))
    gt = torch.from_numpy(g).to(getattr(torch, dtype))
    got = ca.clip_accum(gt, torch.from_numpy(norms), torch.from_numpy(mask),
                        1.3)
    assert got.dtype == torch.float32 and got.shape == (d,)
    args = (gj, jnp.asarray(norms), jnp.asarray(mask), 1.3)
    np.testing.assert_array_equal(_bits(got), np.asarray(
        clip_accum_ref(*args)).view(np.int32))
    np.testing.assert_array_equal(_bits(got), np.asarray(
        ref_clip_accum(*args, interpret=True)).view(np.int32))


def test_clip_accum_equals_the_inplace_fold_from_zero():
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((5, 256)).astype(np.float32))
    norms = torch.from_numpy(rng.random(5).astype(np.float32) * 4)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0])
    want = ca.clip_accum_inplace(torch.zeros(256), g, norms, mask, 1.0)
    assert torch.equal(ca.clip_accum(g, norms, mask, 1.0), want)


@pytest.mark.parametrize("over,exc", [
    (dict(grads=torch.zeros(2, 8, device="meta")), ValueError),
    (dict(grads=torch.zeros(2, 8, dtype=torch.float16)), TypeError),
    (dict(norms=torch.zeros(2, dtype=torch.float64)), TypeError),
    (dict(mask=torch.zeros(3)), ValueError),
    (dict(grads=torch.zeros(8, 2).T), ValueError),
    (dict(grads=torch.zeros(16)), ValueError),
])
def test_clip_accum_rejects_bad_operands(over, exc):
    a = dict(grads=torch.zeros(2, 8), norms=torch.ones(2), mask=torch.ones(2))
    a.update(over)
    with pytest.raises(exc):
        ca.clip_accum(a["grads"], a["norms"], a["mask"], 1.0)


def test_tree_clip_accum_lays_out_and_unflattens():
    rng = np.random.default_rng(8)
    shapes = {"a.w": (3, 5), "b.w": (7,), "a.b": (2, 2, 2)}
    grads = {k: torch.from_numpy(rng.standard_normal((4,) + s).astype(
        np.float32)) for k, s in shapes.items()}
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    view = FlatGradView.for_params(params)
    norms = torch.from_numpy(rng.random(4).astype(np.float32) * 3)
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0])
    flat = torch.stack([view.flatten({k: v[b] for k, v in grads.items()})
                        for b in range(4)])
    want = view.unflatten(ca.clip_accum(flat, norms, mask, 1.0))
    got = ca.tree_clip_accum(dict(grads), norms, mask, 1.0, view)
    assert list(got) == list(view.names)
    for k in shapes:
        assert got[k].shape == shapes[k]
        assert torch.equal(got[k], want[k]), k


@functools.lru_cache(maxsize=None)
def _vit():
    rmodel = ref_build(REF_VIT.reduced())
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build(get_config("vit-base").reduced(), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 100, B).astype(np.int32)
    return (lambda p, b, t: rmodel.loss(p, b, t), rparams,
            {"image": jnp.asarray(x), "label": jnp.asarray(y)},
            model.loss, params,
            {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})


def test_masked_fused_bitwise_equals_masked_pe():
    _, _, _, loss, params, batch = _vit()
    mask = torch.from_numpy(MASK)
    pe, pe_aux = clipping.resolve_engine("masked_pe")(loss, params, batch,
                                                      mask, 1.0)
    got, aux = clipping.resolve_engine("masked_fused")(loss, params, batch,
                                                       mask, 1.0)
    assert list(got) == list(pe)
    for name in pe:
        np.testing.assert_array_equal(_bits(got[name]), _bits(pe[name]),
                                      err_msg=name)
    assert torch.equal(aux["per_example_norms"], pe_aux["per_example_norms"])
    assert torch.equal(aux["clip_coef"], pe_aux["clip_coef"])


def test_masked_fused_matches_reference():
    rloss, rparams, rbatch, loss, params, batch = _vit()
    rsum, raux = ref_clipping.ENGINES["masked_fused"](
        rloss, rparams, rbatch, jnp.asarray(MASK), 1.0)
    tsum, taux = clipping.resolve_engine("masked_fused")(
        loss, params, batch, torch.from_numpy(MASK), 1.0)
    want = flatten_tree(jax.tree.map(np.asarray, rsum))
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(tsum[name].numpy(), w, rtol=0,
                                   atol=2e-5 * scale, err_msg=name)
    np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                               np.asarray(raux["per_example_norms"]),
                               rtol=2e-5)


@pytest.fixture
def ghost_source():
    prev = fused.set_stream_norm_source("ghost")
    rprev = ref_fused.set_stream_norm_source("ghost")
    yield
    fused.set_stream_norm_source(prev)
    ref_fused.set_stream_norm_source(rprev)


def _stream(loss, params, batch, tile):
    view = FlatGradView.for_params(params)
    acc = view.zeros("cpu")
    _, aux = clipping.resolve_engine("masked_fused_stream")(
        loss, params, batch, torch.from_numpy(MASK), 1.0, acc=acc,
        view=view, tile=tile)
    return view, acc, aux


@pytest.mark.parametrize("tile", [4, B])
def test_stream_ghost_norm_source(tile, ghost_source):
    rloss, rparams, rbatch, loss, params, batch = _vit()
    view, acc, aux = _stream(loss, params, batch, tile)
    mask = torch.from_numpy(MASK)
    _, gaux = clipping.resolve_engine("masked_ghost")(loss, params, batch,
                                                      mask, 1.0)
    if tile == B:
        assert torch.equal(aux["per_example_norms"],
                           gaux["per_example_norms"])
        assert torch.equal(aux["clip_coef"], gaux["clip_coef"])
    pe, _ = clipping.resolve_engine("masked_pe")(loss, params, batch, mask,
                                                 1.0)
    want = view.flatten(pe)
    torch.testing.assert_close(acc, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    rsum, _ = ref_clipping.ENGINES["masked_fused_stream"](
        rloss, rparams, rbatch, jnp.asarray(MASK), 1.0, tile=tile)
    rflat = np.concatenate([v.reshape(-1) for v in flatten_tree(
        jax.tree.map(np.asarray, rsum)).values()])
    np.testing.assert_allclose(acc[:view.n_params].numpy(), rflat, rtol=0,
                               atol=2e-5 * float(np.abs(rflat).max()))


def test_stream_norm_source_is_checked_and_restored():
    with pytest.raises(ValueError, match="norm source"):
        fused.set_stream_norm_source("nope")
    prev = fused.set_stream_norm_source("ghost")
    assert fused.set_stream_norm_source(prev) == "ghost"
    assert fused._stream_norm_source == "pe"
