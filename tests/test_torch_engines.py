"""The port's clipping engines: ``masked_pe`` against the reference's
``masked_pe``, and ``masked_fused_stream`` against the port's own
``masked_pe``, on the reduced ViT with the reference's weights.

Tolerances:
* port ``masked_pe`` vs reference ``masked_pe``: 2e-5 of the largest summed
  gradient entry (f32, different matmul stacks), norms 2e-5 relative,
  clip coefficients 2e-5 absolute.
* ``masked_fused_stream`` vs ``masked_pe`` inside the port: BITWISE when the
  tile is the whole batch (the same vmap width on the same batch gives the
  same per-example grads, and the kernel repeats the oracle's fold); within
  1e-5 of the largest entry for smaller tiles, because PyTorch's CPU GEMMs
  give a row other bits at another batch width (PERF.md); and BITWISE, at
  every tile, against the strict fold of the per-example grads taken at
  the engine's own tile width.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vit_base import CONFIG as REF_VIT
from repro.core import clipping as ref_clipping
from repro.models.registry import build as ref_build
from repro_torch.configs import get_config
from repro_torch.core import clipping
from repro_torch.core.engine import DPConfig, build_accumulate_fn
from repro_torch.core.engine import init_state
from repro_torch.models import build
from repro_torch.optim import sgd
from repro_torch.utils.params import (FlatGradView, flatten_tree,
                                      params_from_numpy)

B = 6
MASK = np.array([1, 1, 0, 1, 1, 1], np.float32)


@functools.lru_cache(maxsize=None)
def _setup():
    rmodel = ref_build(REF_VIT.reduced())
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build(get_config("vit-base").reduced(), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 100, B).astype(np.int32)
    return rmodel, rparams, model, params, {"image": x, "label": y}


def _torch_batch(np_batch):
    return {k: torch.from_numpy(v) for k, v in np_batch.items()}


def test_masked_pe_matches_reference():
    rmodel, rparams, model, params, nb = _setup()
    rbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    rsum, raux = jax.jit(lambda p, b, m: ref_clipping.per_example_clipped_grads(
        lambda pp, bb, t: rmodel.loss(pp, bb, t), p, b, m, 1.0))(
        rparams, rbatch, jnp.asarray(MASK))
    tsum, taux = clipping.resolve_engine("masked_pe")(
        model.loss, params, _torch_batch(nb), torch.from_numpy(MASK), 1.0)
    want = flatten_tree(jax.tree.map(np.asarray, rsum))
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(tsum[name].numpy(), w, rtol=0,
                                   atol=2e-5 * scale, err_msg=name)
    np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                               np.asarray(raux["per_example_norms"]),
                               rtol=2e-5)
    np.testing.assert_allclose(taux["clip_coef"].numpy(),
                               np.asarray(raux["clip_coef"]), rtol=0,
                               atol=2e-5)
    assert float(taux["clip_coef"][2]) == 0.0          # masked out


def _stream(params, model, batch, mask, tile):
    view = FlatGradView.for_params(params)
    acc = view.zeros("cpu")
    _, aux = clipping.resolve_engine("masked_fused_stream")(
        model.loss, params, batch, mask, 1.0, acc=acc, view=view, tile=tile)
    return acc, aux


@pytest.mark.parametrize("tile", [1, 2, 4, B])
def test_streaming_matches_masked_pe(tile):
    _, _, model, params, nb = _setup()
    batch, mask = _torch_batch(nb), torch.from_numpy(MASK)
    view = FlatGradView.for_params(params)
    pe_sum, pe_aux = clipping.resolve_engine("masked_pe")(
        model.loss, params, batch, mask, 1.0)
    want = view.flatten(pe_sum)
    got, aux = _stream(params, model, batch, mask, tile)
    assert aux["per_example_norms"].shape == (B,)      # tile padding dropped
    assert not got[view.n_params:].any()               # tail stays zero
    if tile == B:
        assert torch.equal(got, want)
        assert torch.equal(aux["clip_coef"], pe_aux["clip_coef"])
    else:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
        torch.testing.assert_close(aux["per_example_norms"],
                                   pe_aux["per_example_norms"], rtol=1e-5,
                                   atol=0)


@pytest.mark.parametrize("tile", [1, 4])
def test_streaming_equals_the_tilewise_fold(tile):
    """BITWISE: the streaming sum equals one strict left fold, from +0, of
    the per-example grads it sees (vmap(grad) per tile of the batch padded
    by example 0 with mask 0), each row flattened on its own.  The padding,
    the flat layout and the carry across tiles add nothing to the width
    effect above."""
    _, _, model, params, nb = _setup()
    batch, mask = _torch_batch(nb), torch.from_numpy(MASK)
    view = FlatGradView.for_params(params)
    got, _ = _stream(params, model, batch, mask, tile)
    pad = (-B) % tile
    batch = {k: torch.cat([v] + [v[:1]] * pad) for k, v in batch.items()}
    mask = torch.cat([mask, torch.zeros(pad)])
    want = view.zeros("cpu")
    for start in range(0, B + pad, tile):
        sl = slice(start, start + tile)
        grads, sq = clipping.per_example_grads_and_sq(
            model.loss, params, {k: v[sl] for k, v in batch.items()})
        coef, _ = clipping.clip_coef(sq, mask[sl], 1.0)
        for b in range(tile):
            want = want + view.flatten(
                {k: v[b] for k, v in grads.items()}) * coef[b]
    assert torch.equal(got, want)


def test_streaming_standalone_returns_the_summed_dict():
    _, _, model, params, nb = _setup()
    batch, mask = _torch_batch(nb), torch.from_numpy(MASK)
    summed, _ = clipping.resolve_engine("masked_fused_stream")(
        model.loss, params, batch, mask, 1.0, tile=B)
    pe_sum, _ = clipping.resolve_engine("masked_pe")(
        model.loss, params, batch, mask, 1.0)
    assert set(summed) == set(pe_sum)
    for name in pe_sum:
        assert torch.equal(summed[name], pe_sum[name]), name


def test_accumulate_streaming_adds_into_the_carry():
    """Two physical batches through the streaming accumulate equal one
    strict fold over both, from the same carry (no reset between)."""
    _, _, model, params, nb = _setup()
    batch, mask = _torch_batch(nb), torch.from_numpy(MASK)
    cfg = DPConfig(engine="masked_fused_stream", clip_norm=1.0,
                   stream_tile=B)
    acc_fn = build_accumulate_fn(model.loss, cfg)
    state = init_state(dict(params), sgd(0.1, momentum=0.9), (0, 1))
    acc_fn(state, batch, mask)
    acc_fn(state, batch, mask)
    view = FlatGradView.for_params(params)
    twice = view.zeros("cpu")
    for _ in range(2):
        clipping.resolve_engine("masked_fused_stream")(
            model.loss, params, batch, mask, 1.0, acc=twice, view=view,
            tile=B)
    assert torch.equal(state.grad_acc, twice)
    assert float(state.seen) == 2 * MASK.sum()


def test_unknown_engine_lists_the_registry():
    with pytest.raises(KeyError, match="masked_fused_stream"):
        DPConfig(engine="nope").validate()
    assert set(clipping.available_engines()) == {
        "pe", "masked_pe", "masked_fused", "masked_fused_stream",
        "masked_ghost", "masked_bk"}
