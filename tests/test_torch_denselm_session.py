"""The dense decoder LM through the port's host modules and entry points,
against the reference: configs, the registry, ``TokenDataset``, the weight
carry-over and ``PrivacySession.fit()``.

Tolerances: configs, registry names, token streams, leaf names and order,
flat offsets, sampler draws, σ and ε are EXACT (``float.hex`` for the
floats); the carried-over weights land at the reference's offsets bitwise;
parameters and momentum after a 2-step ``fit()`` within 1e-5 of the
largest parameter (per-example grads differ at f32 rounding,
test_torch_denselm.py; the update adds 1 ULP per contracted op,
test_torch_kernels.py), logged losses within 1e-3 — the ViT's bounds
(test_torch_session.py).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.qwen3_1_7b import SLIDING as REF_SWA
from repro.core import DPConfig as RefDPConfig
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.data.synthetic import TokenDataset as RefTokens
from repro.data.synthetic import dataset_for_config as ref_dataset
from repro.models import registry as ref_registry
from repro.utils.params import FlatGradView as RefView
from repro_torch.configs import get_config
from repro_torch.configs.qwen3_1_7b import SLIDING
from repro_torch.core import DPConfig
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.data import (EmbeddingDataset, TokenDataset,
                              dataset_for_config)
from repro_torch.models import (ARCH_IDS, DenseLM, VisionLM, WhisperLM,
                                build)
from repro_torch.utils.params import (FlatGradView, flatten_tree,
                                      params_from_numpy)

DENSE = ["qwen2-0.5b", "qwen3-1.7b", "llama3.2-3b", "deepseek-67b"]
TRAIN = dict(steps=2, n_data=32, seq_len=16, physical_batch=4, q=0.25,
             target_eps=8.0, lr=0.5, seed=0)


@pytest.mark.parametrize("name", [*DENSE, "qwen3-1.7b-swa"])
def test_configs_match_reference(name):
    if name == "qwen3-1.7b-swa":
        port, ref = SLIDING, REF_SWA
    else:
        port, ref = get_config(name), ref_registry.get_config(name)
    for cfg, rcfg in ((port, ref), (port.reduced(), ref.reduced())):
        for f in dataclasses.fields(rcfg):
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
        assert cfg.hd == rcfg.hd


def test_registry():
    """Every architecture of the reference has its config and builds; the
    frontend families' data is an ``EmbeddingDataset``; an unknown family
    raises in both."""
    assert ARCH_IDS == ref_registry.ARCH_IDS
    assert isinstance(build(get_config("qwen2-0.5b").reduced(),
                            device="cpu"), DenseLM)
    for arch, cls in (("llama-3.2-vision-90b", VisionLM),
                      ("whisper-base", WhisperLM)):
        cfg = get_config(arch).reduced()
        assert isinstance(build(cfg, device="cpu"), cls)
        assert isinstance(dataset_for_config(cfg, 4, 8), EmbeddingDataset)
    assert {get_config(a).family for a in ARCH_IDS} == {
        "dense", "moe", "ssm", "hybrid", "vlm", "audio", "vit"}
    odd = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              family="speech")
    with pytest.raises(ValueError, match="unknown model family"):
        build(odd, device="cpu")
    with pytest.raises(ValueError, match="unknown model family"):
        dataset_for_config(odd, 4, 8)


def test_token_dataset_matches_reference():
    cfg = get_config("qwen2-0.5b")
    ds = dataset_for_config(cfg, 50, 33, seed=3)
    ref = ref_dataset(ref_registry.get_config("qwen2-0.5b"), 50, 33, seed=3)
    assert isinstance(ds, TokenDataset) and isinstance(ref, RefTokens)
    idx = np.array([0, 7, 49, 7])
    got, want = ds.fetch(idx), ref.fetch(idx)
    assert set(got) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == np.int32 and got[k].shape == (4, 33)
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    assert got["tokens"].max() < cfg.vocab


def test_weights_carry_over_in_flatten_order():
    """``params_from_numpy`` on DenseLM's tree: the leaf names and order are
    ``jax.tree.flatten``'s (15 leaves for qwen2-0.5b), equal to the port
    model's own parameters, and FlatGradView puts every reference leaf at
    the reference's offset, so a flat ``grad_acc`` or momentum buffer
    compares element by element."""
    rmodel = ref_registry.build(ref_registry.get_config(
        "qwen2-0.5b").reduced())
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    leaves, _ = jax.tree_util.tree_flatten_with_path(rparams)
    names = [".".join(k.key for k in path) for path, _ in leaves]
    assert list(params) == names and len(names) == 15
    own = build(get_config("qwen2-0.5b").reduced(), device="cpu").params()
    assert list(own) == names
    assert [tuple(v.shape) for v in own.values()] == [
        tuple(v.shape) for _, v in leaves]
    view, rview = FlatGradView.for_params(params), RefView.for_tree(rparams)
    assert view.names == tuple(names)
    assert (view.offsets, view.sizes, view.shapes, view.total) == (
        rview.offsets, rview.sizes, rview.shapes, rview.total)
    flat = view.flatten(params).numpy()
    np.testing.assert_array_equal(flat, np.asarray(rview.flatten(rparams)))
    for i, (_, leaf) in enumerate(leaves):
        np.testing.assert_array_equal(
            view.segment(torch.from_numpy(flat), i).numpy(), np.asarray(leaf))


def _reference_noise(ref, steps):
    view = RefView.for_tree(ref.state.params)
    key, out = ref.state.rng, []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.asarray(view.noise(nkey)))
    return out


@pytest.mark.parametrize("engine", ["masked_pe", "masked_fused_stream",
                                    "masked_fused", "masked_ghost",
                                    "masked_bk"])
def test_fit_matches_reference(engine):
    """2 steps of reduced qwen2-0.5b at 16 tokens, the reference's noise fed
    in as the update's operand."""
    ref = RefSession.from_config(
        "qwen2-0.5b", RefDPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        RefTrainConfig(**TRAIN))
    p0 = jax.tree.map(np.asarray, ref.state.params)
    noise = _reference_noise(ref, TRAIN["steps"])
    ref_out = ref.fit()

    port = PrivacySession.from_config(
        "qwen2-0.5b", DPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        TrainConfig(**TRAIN), device="cpu",
        params=params_from_numpy(p0, "cpu"))
    out = port.fit(noise=lambda k: torch.tensor(noise[k]))

    assert out["sigma"].hex() == ref_out["sigma"].hex()
    assert float(out["final_eps"]).hex() == float(ref_out["final_eps"]).hex()
    assert port.dp.expected_batch_size == ref.dp.expected_batch_size
    assert len(out["history"]) == len(ref_out["history"]) == 2
    for got, want in zip(out["history"], ref_out["history"]):
        assert got["logical_batch"] == want["logical_batch"]
        assert got["eps"] == want["eps"]
        assert got["loss"] == pytest.approx(want["loss"], abs=1e-3)
    want = flatten_tree(jax.tree.map(np.asarray, ref.state.params))
    scale = max(float(np.abs(v).max()) for v in want.values())
    moved = 0.0
    for name, w in want.items():
        np.testing.assert_allclose(port.state.params[name].numpy(), w,
                                   rtol=0, atol=1e-5 * scale, err_msg=name)
        moved = max(moved, float(np.abs(w - flatten_tree(p0)[name]).max()))
    assert moved > 1e-3           # the steps really changed the weights
    np.testing.assert_allclose(port.state.opt_state["mom"].numpy(),
                               np.asarray(ref.state.opt_state["mom"]),
                               rtol=0, atol=1e-5 * scale)


def test_cli_trains_the_dense_lm(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                      "--seq-len", "32", "--steps", "1", "--n-data", "16",
                      "--physical", "4", "--q", "0.25", "--engine",
                      "masked_bk", "--describe"])
    assert out["history"] and out["final_eps"] > 0
    assert np.isfinite(out["history"][0]["loss"])
    described = json.loads(capsys.readouterr().out.splitlines()[0])
    assert described["arch"] == "qwen2-0.5b-smoke"
