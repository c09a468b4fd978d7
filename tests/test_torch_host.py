"""The port's host-side modules against the reference's, on the same seeds:
sampler masks, memory-manager batches, synthetic data, ε and σ are
EXACT (the same numpy code on both sides); FlatGradView offsets are equal
one for one; schedules agree to f32 rounding (1e-6 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RefArchConfig
from repro.data import BatchMemoryManager as RefBMM
from repro.data import available_samplers as ref_samplers
from repro.data import make_sampler as ref_make_sampler
from repro.data.synthetic import ImageDataset as RefImages
from repro.launch.costmodel import stream_tile_size as ref_tile
from repro.models import build_by_name
from repro.optim import schedule as ref_sched
from repro.privacy import PrivacyAccountant as RefAccountant
from repro.privacy import calibrate_sigma as ref_calibrate
from repro.utils.params import FlatGradView as RefView
from repro_torch.configs import get_config
from repro_torch.data import BatchMemoryManager, available_samplers
from repro_torch.data import make_sampler
from repro_torch.data.synthetic import ImageDataset
from repro_torch.launch.costmodel import STREAM_PE_SLABS, stream_tile_size
from repro_torch.models import build
from repro_torch.optim import schedule
from repro_torch.privacy import PrivacyAccountant, calibrate_sigma
from repro_torch.utils.params import FlatGradView, params_from_numpy


def test_same_sampler_registry():
    assert available_samplers() == ref_samplers()


@pytest.mark.parametrize("name", ref_samplers())
def test_sampler_masks_equal(name):
    for q in (0.1, 0.25):
        a = make_sampler(name, n=97, q=q, seed=5)
        b = ref_make_sampler(name, n=97, q=q, seed=5)
        assert a.q == b.q
        assert a.expected_batch_size == b.expected_batch_size
        for k in (0, 1, 2, 7, 31):
            np.testing.assert_array_equal(a.at_step(k), b.at_step(k))
        tail = [x.tolist() for x in make_sampler(name, n=97, q=q, seed=5,
                                                 steps=3, start_step=4)]
        assert tail == [b.at_step(k).tolist() for k in (4, 5, 6)]


def test_batch_memory_manager_batches_equal():
    ds, rds = ImageDataset(40, size=8, seed=3), RefImages(40, size=8, seed=3)
    idx = make_sampler("poisson", n=40, q=0.3, seed=1).at_step(0)
    got = list(BatchMemoryManager(ds.fetch, 4).batches(idx))
    want = list(RefBMM(rds.fetch, 4).batches(idx))
    assert len(got) == len(want) == -(-len(idx) // 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mask, w.mask)
        for k in w.data:
            np.testing.assert_array_equal(g.data[k], w.data[k])
        assert (g.is_last, g.logical_size) == (w.is_last, w.logical_size)
    # padding rows re-fetch index 0 with mask 0
    last = got[-1]
    pad = int((last.mask == 0).sum())
    if pad:
        np.testing.assert_array_equal(last.data["image"][-1],
                                      ds.fetch(np.array([0]))["image"][0])


@pytest.mark.parametrize("name", ref_samplers())
def test_epsilon_and_sigma_exact(name):
    q = make_sampler(name, n=512, q=0.125).q
    sigma = calibrate_sigma(8.0, q, 30, 1e-5, sampler=name)
    assert sigma.hex() == ref_calibrate(8.0, q, 30, 1e-5,
                                        sampler=name).hex()
    acc, ref = PrivacyAccountant(delta=1e-5), RefAccountant(delta=1e-5)
    for s in (sigma, sigma, 1.3):
        acc.step(q, s, sampler=name)
        ref.step(q, s, sampler=name)
    assert float(acc.epsilon()).hex() == float(ref.epsilon()).hex()
    assert acc.state_dict() == ref.state_dict()


def test_flat_grad_view_matches_reference_on_reduced_vit():
    rmodel, _ = build_by_name("vit-base", smoke=True)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    rview = RefView.for_tree(rparams)
    view = FlatGradView.for_params(
        build(get_config("vit-base").reduced(), device="cpu").params())
    assert view.offsets == rview.offsets
    assert view.sizes == rview.sizes
    assert view.shapes == rview.shapes
    assert view.total == rview.total and view.total % 256 == 0
    # the carried-over weights land at the reference's offsets
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    flat = view.flatten(params).numpy()
    np.testing.assert_array_equal(flat, np.asarray(rview.flatten(rparams)))
    assert not flat[view.n_params:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_grad_view_add_into_is_the_flat_add(dtype):
    """add_into adds each leaf into its offset range: bitwise the add of the
    flattened tree, padding untouched."""
    params = build(get_config("vit-base").reduced(), device="cpu").params()
    view = FlatGradView.for_params(params)
    gen = torch.Generator().manual_seed(0)
    tree = {n: torch.randn(p.shape, generator=gen).to(dtype)
            for n, p in params.items()}
    acc = torch.randn(view.total, generator=gen)
    want = acc.clone().add_(view.flatten(tree))
    got = view.add_into(acc, tree)
    assert got is acc and torch.equal(got.view(torch.int32),
                                      want.view(torch.int32))


def test_leaf_order_is_key_chain_order():
    """jax.tree.flatten sorts keys per level, not the joined strings."""
    tree = {"a-b": np.zeros(1), "a": {"b": np.zeros(2), "c": np.zeros(3)},
            "ab": np.zeros(4)}
    rview = RefView.for_tree(jax.tree.map(jnp.asarray, tree))
    view = FlatGradView.for_params(params_from_numpy(tree, "cpu"))
    assert view.names == ("a.b", "a.c", "a-b", "ab")
    assert view.sizes == rview.sizes and view.offsets == rview.offsets


def test_arch_config_reduced_matches_reference():
    port = get_config("vit-base").reduced()
    from repro.configs.vit_base import CONFIG as REF
    assert isinstance(REF, RefArchConfig)
    ref = REF.reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "image_size", "patch", "n_classes", "hd", "name", "dtype"):
        assert getattr(port, f) == getattr(ref, f), f
    assert get_config("vit-base").act_dtype == torch.bfloat16


@pytest.mark.parametrize("budget", [2 ** 20, 2 ** 28, 16 * 2 ** 30])
def test_stream_tile_size_rule(budget):
    """The reference's rule with STREAM_PE_SLABS slabs per example: the
    port's backward holds two gradient slabs at once, plus activations and
    the allocator's headroom."""
    for batch, n in ((32, 86_000_000), (8, 300_000), (5, 10)):
        assert stream_tile_size(batch, n, budget) == ref_tile(
            batch, n, budget_bytes=budget,
            pe_dtype_bytes=4 * STREAM_PE_SLABS)


def test_stream_tile_size_arithmetic():
    """ViT-Base (85,866,340 params) on an 80 GB card: every example costs
    four f32 slabs; the acc and one buffer come off the top."""
    n, slab = 85_866_340, 4 * 85_866_340
    assert STREAM_PE_SLABS == 4
    budget = 80e9
    want = int((budget - 2 * slab) // (4 * slab))
    assert want == 57
    assert stream_tile_size(128, n, budget) == want
    assert stream_tile_size(32, n, budget) == 32        # the batch binds
    # the tile's modelled bytes stay inside the budget, one more do not
    assert 2 * slab + want * 4 * slab <= budget < 2 * slab + (want + 1) * 4 * slab
    assert stream_tile_size(128, n, 2 * slab) == 1       # never below one
    assert stream_tile_size(128, n, 16 * 2 ** 30, pe_dtype_bytes=2) == int(
        (16 * 2 ** 30 - 2 * slab) // (4 * 2 * n))


def test_schedules_match_reference():
    pairs = [(schedule.constant(0.1), ref_sched.constant(0.1)),
             (schedule.cosine(0.1, 10), ref_sched.cosine(0.1, 10)),
             (schedule.linear_warmup_cosine(0.1, 3, 10),
              ref_sched.linear_warmup_cosine(0.1, 3, 10))]
    for mine, ref in pairs:
        for step in range(12):
            want = float(ref(jnp.asarray(step, jnp.int32)))
            assert mine(step) == pytest.approx(want, rel=1e-6, abs=1e-9)
