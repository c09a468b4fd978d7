"""The port's MoE family (``models/moe.py``, ``models/mla.py`` and
``core/layers.py``'s ``dense_stacked`` / ``dense_stacked_pair``) against
the reference's, with the reference's weights carried over by
``params_from_numpy`` and inputs made from a numpy seed.

Models: reduced olmoe-1b-7b (2 layers, d 128, 4 heads of 32 with
qk-norm, 4 experts top-2 of width 64) and reduced deepseek-v2-lite-16b
(MLA with a latent of 32 and a RoPE key of 16; one dense layer with the
config's ``dense_d_ff`` of 10,944, one MoE layer with 4 routed experts
top-2 and 1 shared).

The reference fails ``tests/test_engine_e2e.py::
test_streaming_parity_all_archs[deepseek-v2-lite-16b]`` (its own bitwise
streaming claim); no test here holds the port to that point.  The port's
own claim (the stream equals ``masked_pe`` bitwise at tile = batch) is
tested in ``test_torch_moe_engines.py``.

Tolerances:
* routing (f32): the selected experts, their order and the kept-at-
  capacity mask equal the reference's exactly, ties and drops included;
  the block's output and aux loss 2e-6 of the largest entry (other
  summation orders in f32; measured 2.5e-7 and 9.1e-8).
* ``dense_stacked``: f32 1e-6 of the largest output, bf16 2^-7 of it (one
  bf16 step where an f32 sum rounds the other way); its norms 1e-5
  relative and BK grads 1e-5 of the largest entry at one and two layer
  axes, ghost and direct paths (test_torch_ghost.py's bounds).
* ``mla_attention``: f32 2e-6 of the largest output (measured 4.2e-7);
  bf16 2^-7 of it, one bf16 step (measured: equal).
* per-example losses, grads and squared norms: f32 2e-5 (grads of the
  largest entry; measured up to 2.1e-6); bf16 at DenseLM's bounds 2e-2 /
  5e-2 / 5e-2 (measured up to 2.9e-3 / 2.7e-2 / 4.9e-3, deepseek's grads
  the widest: bf16 rounding ties broken the other way, as on the dense
  and SSM models).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as ref_layers
from repro.core.clipping import per_example_grads_and_sq as ref_pe
from repro.core.tape import Tape as RefTape
from repro.data.synthetic import dataset_for_config as ref_dataset
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro.utils.params import FlatGradView as RefView
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import layers as L
from repro_torch.core.clipping import per_example_grads_and_sq
from repro_torch.core.tape import LayerSpec, Tape, scan_blocks
from repro_torch.data import (EmbeddingDataset, TokenDataset,
                              dataset_for_config)
from repro_torch.models import (DeepseekV2LM, MoeLM, VisionLM, WhisperLM,
                                build)
from repro_torch.models import common as cm
from repro_torch.models import mla, moe
from repro_torch.utils.params import (FlatGradView, flatten_tree,
                                      params_from_numpy)

MOE = {"olmoe": "olmoe-1b-7b", "deepseek": "deepseek-v2-lite-16b"}
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 5e-2)}
B, T = 3, 32


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: many small ops stall on thread barriers when
    several test workers share the machine's cores (every side of each
    comparison runs in this process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref_init(name):
    rmodel = ref_registry.build(ref_registry.get_config(MOE[name]).reduced())
    return jax.jit(rmodel.init)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pair(name, dtype="float32"):
    rcfg = ref_registry.get_config(MOE[name]).reduced(dtype=dtype)
    cfg = get_config(MOE[name]).reduced(dtype=dtype)
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


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# configs, registry, data, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MOE))
def test_configs_match_reference(name):
    port, ref = get_config(MOE[name]), ref_registry.get_config(MOE[name])
    for cfg, rcfg in ((port, ref), (port.reduced(), ref.reduced())):
        for f in dataclasses.fields(rcfg):
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
        assert cfg.hd == rcfg.hd


@pytest.mark.parametrize("name,cls", [("olmoe", MoeLM),
                                      ("deepseek", DeepseekV2LM)])
def test_registry_builds_the_family(name, cls):
    model = build(get_config(MOE[name]).reduced(), device="cpu")
    assert type(model) is cls
    assert type(ref_registry.build(
        ref_registry.get_config(MOE[name]).reduced())).__name__ == cls.__name__


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_registry_raises_for_the_families_left(family):
    """The last two families build (no family is left to raise for), their
    data is an ``EmbeddingDataset``, and an unknown family still raises."""
    arch = {"vlm": "llama-3.2-vision-90b", "audio": "whisper-base"}[family]
    cls = {"vlm": VisionLM, "audio": WhisperLM}[family]
    cfg = get_config(arch).reduced()
    assert cfg.family == family
    assert type(build(cfg, device="cpu")) is cls
    assert isinstance(dataset_for_config(cfg, 4, 8), EmbeddingDataset)
    other = ArchConfig(name="x", family=family + "-x", n_layers=1,
                       d_model=8, n_heads=1, n_kv_heads=1, d_ff=8, vocab=8)
    with pytest.raises(ValueError, match="unknown model family"):
        build(other, device="cpu")


def test_token_dataset_matches_reference():
    ds = dataset_for_config(get_config(MOE["olmoe"]), 20, 17, seed=5)
    ref = ref_dataset(ref_registry.get_config(MOE["olmoe"]), 20, 17, seed=5)
    assert isinstance(ds, TokenDataset)
    idx = np.array([3, 0, 19])
    got, want = ds.fetch(idx), ref.fetch(idx)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", sorted(MOE))
def test_weights_carry_over_in_flatten_order(name):
    """The port model's own leaves are the reference's, by name, order and
    shape ((n_layers, E, d, f) experts included), and FlatGradView puts
    every reference leaf at the reference's offset."""
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
    prefix = "blocks" if name == "olmoe" else "moe_blocks"
    assert own[f"{prefix}.moe.w1.w"].shape[:2] == (
        model.cfg.n_layers - model.cfg.first_dense_layers, 4)


class _CPUGenerator(torch.Generator):
    """A CPU generator whatever device is asked for (the meta device has
    none)."""

    def __new__(cls, device=None):
        return super().__new__(cls)

    def __init__(self, device=None):
        super().__init__()


@pytest.mark.parametrize("name,counts", [
    ("olmoe", {16: 6_919_100_416, 3: 1_464_744_704}),
    ("deepseek", {27: 15_706_484_224, 2: 1_085_287_424})])
def test_full_width_parameter_counts(name, counts, monkeypatch):
    """The full configs' leaf shapes and counts against the reference's
    tree at full depth and at the depth chip_smoke.py trains, neither
    materialised (the port's model on the meta device)."""
    monkeypatch.setattr(torch, "Generator", _CPUGenerator)
    for n, want_count in counts.items():
        rcfg = dataclasses.replace(ref_registry.get_config(MOE[name]),
                                   n_layers=n)
        shapes = jax.eval_shape(ref_registry.build(rcfg).init,
                                jax.random.PRNGKey(0))
        want = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
        model = build(dataclasses.replace(get_config(MOE[name]), n_layers=n),
                      device="meta")
        got = {k: tuple(v.shape) for k, v in model.params().items()}
        assert got == want
        assert sum(int(np.prod(s)) for s in got.values()) == want_count


# ---------------------------------------------------------------------------
# dense_stacked and dense_stacked_pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_stacked_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 2, 5, 16)).astype(np.float32)
    w = (rng.standard_normal((4, 16, 8)) / 4).astype(np.float32)
    want = ref_layers.dense_stacked(
        RefTape(), "d", jnp.asarray(x, dtype), jnp.asarray(w),
        param_path="p")
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = L.dense_stacked(Tape(), "d", tx, torch.from_numpy(w),
                          param_path="p")
    assert got.dtype == tx.dtype
    _close(got, np.asarray(want.astype(jnp.float32)),
           1e-6 if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("path", ["ghost", "direct"])
@pytest.mark.parametrize("n_outer", [0, 2])
def test_dense_stacked_companions_match_reference(n_outer, path,
                                                  monkeypatch):
    """Norms and BK grads of a ``dense_stacked`` record whose E axis is a
    tensor axis, alone (('layers',)) and under a scanned stack
    (('layers', 'layers'): a list level outside, the tensor axis inside),
    against the reference's companions on the stacked arrays; BK grads come
    back with the (n_layers, E, din, dout) leaf shape."""
    rng = np.random.default_rng(7)
    lead = ((n_outer,) if n_outer else ()) + (4,)
    b, t, din, dout = 3, 6, 5, 7
    x = rng.standard_normal(lead + (b, t, din)).astype(np.float32)
    dy = rng.standard_normal(lead + (b, t, dout)).astype(np.float32)
    coef = np.array([0.5, 0.0, 1.25], np.float32)
    stack = ("layers",) * len(lead)
    meta = (("has_bias", False),)
    rspec = ref_layers.LayerSpec("dense", stack=stack, param_path="p",
                                 meta=meta)
    spec = LayerSpec("dense", stack=stack, param_path="p", meta=meta)
    monkeypatch.setattr(ref_layers, "_FORCE_PATH", path)
    monkeypatch.setattr(L, "_FORCE_PATH", path)
    calls = []
    kernel = L.ghost_norm_dense
    monkeypatch.setattr(L, "ghost_norm_dense",
                        lambda a, d: calls.append(a.shape) or kernel(a, d))

    def port(a):
        a = torch.from_numpy(a)
        return list(a) if n_outer else a

    want = ref_layers.per_example_sq_norm(rspec, {"x": jnp.asarray(x)},
                                          jnp.asarray(dy))
    got = L.per_example_sq_norm(spec, {"x": port(x)}, port(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    if path == "direct":
        # the E experts of a layer in one kernel call
        assert calls == [(4 * b, t, din)] * max(n_outer, 1)
    rbk = ref_layers.bk_grads(rspec, {"x": jnp.asarray(x)}, jnp.asarray(dy),
                              jnp.asarray(coef))["p.w"]
    tbk = L.bk_grads(spec, {"x": port(x)}, port(dy),
                     torch.from_numpy(coef))["p.w"]
    assert tuple(tbk.shape) == lead + (din, dout)
    _close(tbk, rbk, 1e-5)


def test_dense_stacked_pair_records_its_input_once():
    """Under a scanned stack the pair's two specs are the reference's
    (('layers', 'layers'), the second with ``record_of``); the second has
    no record of its own, and ``resolve_record`` hands it the first's; its
    norms and BK grads equal those of a ``dense_stacked`` on that input."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 4, 3, 5, 6)).astype(
        np.float32))
    w1 = torch.from_numpy(rng.standard_normal((2, 4, 6, 7)).astype(
        np.float32))
    w3 = torch.from_numpy(rng.standard_normal((2, 4, 6, 7)).astype(
        np.float32))

    def body(sub, p, acc):
        g, u = L.dense_stacked_pair(sub, "moe.w13", p["x"], p["w1"], p["w3"],
                                    param_path1="blocks.w1",
                                    param_path2="blocks.w3")
        return acc + (g * u).sum(dim=(0, 2, 3))

    tape = Tape(Tape.RECORD)
    out = scan_blocks(tape, "blocks", body, {"x": x, "w1": w1, "w3": w3},
                      torch.zeros(3), 2)
    rtape = RefTape(RefTape.COLLECT)
    jax.eval_shape(lambda xx, a, c: ref_layers.dense_stacked_pair(
        rtape, "moe.w13", xx, a, c, param_path1="blocks.w1",
        param_path2="blocks.w3"), *(jnp.asarray(v[0].numpy())
                                    for v in (x, w1, w3)))
    for n in ("a", "b"):
        spec, rspec = tape.specs[f"blocks/moe.w13.{n}"], rtape.specs[
            f"moe.w13.{n}"]
        assert spec.stack == ("layers",) + rspec.stack == ("layers", "layers")
        assert (spec.kind, spec.param_path, spec.meta) == (
            rspec.kind, rspec.param_path, rspec.meta)
    b_name = "blocks/moe.w13.b"
    assert tape.records[b_name] == {}
    rec = L.resolve_record(tape.records, b_name, tape.specs[b_name])
    assert rec is tape.records["blocks/moe.w13.a"]
    dys = torch.autograd.grad(out.sum(), tape.eps[b_name])
    coef = torch.tensor([1.0, 0.5, 0.0])
    alone = LayerSpec("dense", stack=("layers", "layers"),
                      param_path="blocks.w3", meta=(("has_bias", False),))
    dys = list(dys)
    for fn in (L.per_example_sq_norm,
               lambda s, r, d: L.bk_grads(s, r, d, coef)["blocks.w3.w"]):
        assert torch.equal(fn(tape.specs[b_name], rec, dys),
                           fn(alone, {"x": list(x.unbind(0))}, dys))


# ---------------------------------------------------------------------------
# routing and the MoE block
# ---------------------------------------------------------------------------

def _block_inputs(name, seed=0, **over):
    rcfg = ref_registry.get_config(MOE[name]).reduced(**over)
    cfg = get_config(MOE[name]).reduced(**over)
    layer = "blocks" if name == "olmoe" else "moe_blocks"
    rp = jax.tree.map(lambda a: np.asarray(a)[0], _ref_init(name)[layer][
        "moe"])
    x = np.random.default_rng(seed).standard_normal((B, T, cfg.d_model)
                                                    ).astype(np.float32)
    return rcfg, cfg, rp, x


def _ref_block(rcfg, rp, x, monkeypatch):
    """The reference's moe_block, eagerly, with the experts its
    ``jax.lax.top_k`` picked."""
    picked = []
    top_k = jax.lax.top_k

    def recording(a, k):
        out = top_k(a, k)
        picked.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    y, aux = ref_moe.moe_block(RefTape(), "moe", "blocks.moe",
                               jax.tree.map(jnp.asarray, rp), jnp.asarray(x),
                               rcfg)
    return np.asarray(y), np.asarray(aux), picked[0]


def _kept(e_flat, E, cap):
    """The capacity rule on numpy: slot = how many earlier virtual tokens
    of the example chose the same expert; kept below ``cap``."""
    out = np.zeros(e_flat.shape, bool)
    for b in range(e_flat.shape[0]):
        seen = np.zeros(E, int)
        for i, e in enumerate(e_flat[b]):
            out[b, i] = seen[e] < cap
            seen[e] += 1
    return out


def _port_block(cfg, rp, x):
    p = {f"{k}.w": torch.from_numpy(np.array(v["w"]))
         for k, v in rp.items()}
    with moe.capture_routing() as got:
        y, aux = moe.moe_block(Tape(), "moe", "blocks.moe", p,
                               torch.from_numpy(x), cfg)
    return y, aux, got


@pytest.mark.parametrize("name,over", [
    ("olmoe", {}), ("deepseek", {}),
    ("olmoe", {"capacity_factor": 0.5}), ("deepseek", {"top_k": 3})])
def test_moe_block_routes_as_the_reference(name, over, monkeypatch):
    """f32: the same experts in the same order for every token, the same
    kept mask (at the default capacity and at a tight one that drops about
    half the assignments), and the output and aux within 2e-6."""
    rcfg, cfg, rp, x = _block_inputs(name, **over)
    ry, raux, rtopi = _ref_block(rcfg, rp, x, monkeypatch)
    y, aux, (e_flat, valid) = _port_block(cfg, rp, x)
    want_e = rtopi.reshape(B, T * cfg.top_k)
    np.testing.assert_array_equal(e_flat.numpy(), want_e)
    kept = _kept(want_e, cfg.n_experts, moe.capacity(T, cfg))
    np.testing.assert_array_equal(valid.numpy(), kept)
    if over.get("capacity_factor"):
        assert 0.3 < 1 - kept.mean() < 0.7
    _close(y, ry, 2e-6, "y")
    _close(aux, raux, 2e-6, "aux")


def test_topk_ties_take_the_lower_expert_first(monkeypatch):
    """A zero router: every probability ties, the reference's ``top_k``
    takes experts 0 and 1 for every token, and so does the port, with the
    same slots and the same drops at capacity."""
    rcfg, cfg, rp, x = _block_inputs("olmoe")
    rp = dict(rp, router={"w": np.zeros_like(rp["router"]["w"])})
    ry, raux, rtopi = _ref_block(rcfg, rp, x, monkeypatch)
    y, aux, (e_flat, valid) = _port_block(cfg, rp, x)
    assert (rtopi == np.arange(cfg.top_k)).all()
    np.testing.assert_array_equal(e_flat.numpy(),
                                  rtopi.reshape(B, T * cfg.top_k))
    assert not bool(valid.all())      # 32 tokens each for experts 0 and 1
    _close(y, ry, 2e-6, "y")
    _close(aux, raux, 2e-6, "aux")


def test_moe_block_under_vmap_grad_equals_the_batched_grad():
    """The block under ``torch.func.vmap(grad)`` (the per-example engines'
    path) gives each row the gradient the batched backward gives it."""
    _, cfg, rp, x = _block_inputs("olmoe", capacity_factor=0.5)
    p = {f"{k}.w": torch.from_numpy(np.array(v["w"]))
         for k, v in rp.items()}
    xt = torch.from_numpy(x)

    def f(pp, xx):
        y, aux = moe.moe_block(Tape(), "moe", "m", pp, xx[None], cfg)
        return y.square().sum() + aux.sum()

    g = torch.func.vmap(torch.func.grad(f), in_dims=(None, 0))(p, xt)
    for b in range(B):
        want = torch.func.grad(f)(p, xt[b])
        for k in p:
            np.testing.assert_allclose(g[k][b].numpy(), want[k].numpy(),
                                       rtol=0, atol=1e-6 * float(
                                           want[k].abs().max()), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_reference(dtype):
    rcfg = ref_registry.get_config(MOE["deepseek"]).reduced(dtype=dtype)
    cfg = get_config(MOE["deepseek"]).reduced(dtype=dtype)
    rp = jax.tree.map(lambda a: np.asarray(a)[0],
                      _ref_init("deepseek")["dense_blocks"]["attn"])
    x = np.random.default_rng(4).standard_normal((B, T, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want = ref_mla.mla_attention(RefTape(), "attn", "a",
                                 jax.tree.map(jnp.asarray, rp),
                                 jnp.asarray(x, dtype), rcfg,
                                 jnp.asarray(pos))
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in
         flatten_tree(rp).items()}
    got = mla.mla_attention(Tape(), "attn", "a", p,
                            torch.from_numpy(x).to(getattr(torch, dtype)),
                            cfg, torch.from_numpy(pos.copy()))
    _close(got, np.asarray(want.astype(jnp.float32)),
           2e-6 if dtype == "float32" else 2.0 ** -7)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MOE))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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


@pytest.mark.parametrize("name", sorted(MOE))
def test_logits_and_aux_match_reference(name):
    """The logits of a fresh model loaded with the reference's weights, and
    the loss as the CE plus the per-example aux (the reference's
    ``lm_head_ce(...) + aux``), the aux a (B,) f32 of its own."""
    rmodel, rparams, rbatch, model, params, batch = _pair(name)
    rlogits, raux = rmodel.logits_aux(rparams, rbatch["tokens"], RefTape())
    fresh = build(model.cfg, device="cpu")
    fresh.load_state_dict(params)
    _close(fresh.logits(batch["tokens"]), rlogits, 2e-6, "logits")
    x, aux = fresh.backbone_aux(batch["tokens"], Tape())
    assert aux.dtype == torch.float32 and aux.shape == (B,)
    _close(aux, raux, 2e-6, "aux")
    ce = cm.lm_head_ce(Tape(), fresh.head.w, x, batch["labels"], model.cfg)
    assert torch.equal(fresh(batch["tokens"], batch["labels"]), ce + aux)


def test_families_without_aux_keep_the_plain_ce():
    """DenseLM's loss is the CE itself: no aux term is added."""
    model = build(get_config("qwen2-0.5b").reduced(), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 97, (2, 9)).astype(np.int32))
    x, aux = model.backbone_aux(toks[:, :-1], Tape())
    assert aux is None
    assert torch.equal(model(toks[:, :-1], toks[:, 1:]), cm.lm_head_ce(
        Tape(), model.head.w, x, toks[:, 1:], model.cfg))


@pytest.mark.parametrize("name", sorted(MOE))
def test_cli_trains_the_family(name, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", MOE[name], "--smoke", "--device", "cpu",
                      "--seq-len", "16", "--steps", "1", "--n-data", "16",
                      "--physical", "4", "--q", "0.25", "--engine",
                      "masked_bk", "--describe"])
    assert out["history"] and np.isfinite(out["history"][0]["loss"])
    described = json.loads(capsys.readouterr().out.splitlines()[0])
    assert described["arch"] == MOE[name] + "-smoke"
