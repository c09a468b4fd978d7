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
from repro.core.tape import Tape
from repro.models.registry import build as ref_build
from repro_torch.configs import get_config
from repro_torch.core.clipping import per_example_grads_and_sq
from repro_torch.models import build
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
    want = np.asarray(jax.jit(lambda p, b: rmodel.loss(p, b, Tape()))(
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
