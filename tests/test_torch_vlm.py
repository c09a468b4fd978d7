"""The port's cross-attention VLM (``models/vlm.py``, the 0-d gate through
``core/layers.py``'s ``scale`` companions, ``EmbeddingDataset``) against
the reference's, with the reference's weights carried over by
``params_from_numpy`` and inputs made from a numpy seed.

Model: reduced llama-3.2-vision-90b (``cross_every`` 2, so one super: one
RoPE self-attention SwiGLU layer in ``supers.selfb`` and one gated
cross-attention layer in ``supers.crossb``; d 128, 4 heads of 32 over 2 KV
heads, d_ff 256, vocab 97, 8 image tokens of 48; f32 unless stated).

The reference initialises every gate to 0, which makes the cross
attention's and ``proj``'s gradients exactly zero: a comparison on fresh
weights would hold zero against zero on those leaves.  So every case here
sets each gate to a non-zero value drawn from the test's seed in the
reference's numpy params, and carries it across.

Tolerances:
* ``EmbeddingDataset``: bitwise.
* ``cross_attention`` (GQA, 8 keys for 16 queries): f32 2e-6 of the
  largest output; bf16 2^-7 of it, one bf16 step.
* the 0-d ``scale``: norms 1e-5 relative and BK grads 1e-5 of the largest
  entry against the reference's companions (test_torch_ghost.py's bounds).
* per-example losses, grads and squared norms: f32 2e-5 (grads of the
  largest entry; measured 9.5e-7 / 8.7e-7 / 3.0e-7); bf16 at DenseLM's
  bounds 2e-2 / 5e-2 / 5e-2 (measured 2.0e-3 / 1.1e-2 / 4.0e-3).
* every engine's clipped sum against the reference's: 2e-5 of the largest
  entry; norms 2e-5 relative; clip coefficients 2e-5 absolute.
* every dense layer's norm through the kernel's plain version (forced
  direct path) against the Gram path: 1e-5 relative.
* 2-step ``fit()`` with the reference's noise: masks, σ and ε exact;
  params and momentum 1e-5 of the largest parameter; losses 1e-3.
* a checkpoint round trip: params, momentum and ε bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPConfig as RefDPConfig
from repro.core import clipping as ref_clipping
from repro.core import layers as ref_layers
from repro.core.clipping import per_example_grads_and_sq as ref_pe
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.core.tape import Tape as RefTape
from repro.data.synthetic import dataset_for_config as ref_dataset
from repro.models import common as ref_cm
from repro.models import registry as ref_registry
from repro.utils.params import FlatGradView as RefView
from repro_torch.configs import get_config
from repro_torch.core import DPConfig, clipping
from repro_torch.core import layers as L
from repro_torch.core.clipping import per_example_grads_and_sq
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.core.tape import LayerSpec, Tape
from repro_torch.data import EmbeddingDataset, dataset_for_config
from repro_torch.models import VisionLM, build
from repro_torch.models import common as cm
from repro_torch.utils.params import (FlatGradView, flatten_tree,
                                      params_from_numpy)

ARCH = "llama-3.2-vision-90b"
GATE = "supers.crossb.gate.w"
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 5e-2)}
B, T = 4, 16
MASK = np.array([1, 1, 0, 1], np.float32)
ENGINES = ["masked_pe", "masked_fused", "masked_fused_stream",
           "masked_ghost", "masked_bk"]


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: many small ops stall on thread barriers when
    several test workers share the machine's cores (every side of each
    comparison runs in this process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _open_gates(tree, seed):
    """The reference's numpy params with every gate set to a value drawn
    from ``seed`` in [0.5, 1.5) (the reference initialises them to 0)."""
    tree = jax.tree.map(np.array, tree)
    gate = tree["supers"]["crossb"]["gate"]
    gate["w"] = np.random.default_rng(seed).uniform(
        0.5, 1.5, gate["w"].shape).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _ref_init():
    rmodel = ref_registry.build(ref_registry.get_config(ARCH).reduced())
    return _open_gates(jax.jit(rmodel.init)(jax.random.PRNGKey(0)), 11)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32", seed=0):
    """The reference's model, params and batch, and the port's, with the
    reference's weights (its gates opened)."""
    rcfg = ref_registry.get_config(ARCH).reduced(dtype=dtype)
    cfg = get_config(ARCH).reduced(dtype=dtype)
    rmodel = ref_registry.build(rcfg)
    rparams = jax.tree.map(jnp.asarray, _ref_init())
    model = build(cfg, device="cpu")
    params = params_from_numpy(_ref_init(), "cpu")
    assert float(params[GATE].abs().min()) >= 0.5
    rng = np.random.default_rng(seed)
    front = rng.standard_normal((B, cfg.n_image_tokens,
                                 cfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    rbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:]),
              "frontend": jnp.asarray(front)}
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             "frontend": torch.from_numpy(front)}
    return rmodel, rparams, rbatch, model, params, batch


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _hold(got, rtree, tol):
    """Each leaf of ``got`` within ``tol`` of the largest entry of the
    reference's tree; the gate's and ``proj``'s grads must not be zero."""
    want = flatten_tree(jax.tree.map(np.asarray, rtree))
    assert set(want) == set(got)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].detach().float().numpy(), w,
                                   rtol=0, atol=tol * scale, err_msg=name)
    for name in (GATE, "proj.w", "supers.crossb.xattn.wk.w"):
        assert float(np.abs(want[name]).max()) > 1e-3 * scale, name


# ---------------------------------------------------------------------------
# configs, data, weights
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    port, ref = get_config(ARCH), ref_registry.get_config(ARCH)
    for cfg, rcfg in ((port, ref), (port.reduced(), ref.reduced())):
        for f in dataclasses.fields(rcfg):
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name


def test_embedding_dataset_matches_reference():
    """``n_image_tokens`` patches of ``frontend_dim`` with the text tokens,
    bit for bit."""
    cfg = get_config(ARCH).reduced()
    ds = dataset_for_config(cfg, 20, 9, seed=4)
    ref = ref_dataset(ref_registry.get_config(ARCH).reduced(), 20, 9, seed=4)
    assert isinstance(ds, EmbeddingDataset)
    idx = np.array([3, 0, 19, 3])
    got, want = ds.fetch(idx), ref.fetch(idx)
    assert got["frontend"].shape == (4, cfg.n_image_tokens, cfg.frontend_dim)
    for k in ("frontend", "tokens", "labels"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_weights_carry_over_in_flatten_order():
    """The port model's leaves are the reference's, by name, order and
    shape (``supers.selfb.*`` with leading (n_super, self_per), the gate a
    (n_super,) leaf of one 0-d scalar per super), and FlatGradView puts
    every reference leaf at the reference's offset."""
    _, rparams, _, model, params, _ = _pair()
    leaves, _ = jax.tree_util.tree_flatten_with_path(rparams)
    names = [".".join(k.key for k in path) for path, _ in leaves]
    own = model.params()
    assert list(params) == list(own) == names
    assert [tuple(v.shape) for v in own.values()] == [
        tuple(v.shape) for _, v in leaves]
    assert own[GATE].shape == (1,) and float(own[GATE].abs().max()) == 0.0
    assert own["supers.selfb.attn.wq.w"].shape[:2] == (1, 1)
    view, rview = FlatGradView.for_params(params), RefView.for_tree(rparams)
    assert (view.names, view.offsets, view.sizes, view.total) == (
        tuple(names), rview.offsets, rview.sizes, rview.total)
    np.testing.assert_array_equal(view.flatten(params).numpy(),
                                  np.asarray(rview.flatten(rparams)))


class _CPUGenerator(torch.Generator):
    """A CPU generator whatever device is asked for (the meta device has
    none)."""

    def __new__(cls, device=None):
        return super().__new__(cls)

    def __init__(self, device=None):
        super().__init__()


@pytest.mark.parametrize("n_layers,want_count", [
    (100, 87_677_280_276), (2, 3_823_149_057)])
def test_full_width_parameter_counts(n_layers, want_count, monkeypatch):
    """The full config (100 layers, a cross layer every 5) and the depth
    chip_smoke.py trains (2 layers with ``cross_every`` 2): the leaf shapes
    of the reference's tree (``jax.eval_shape``) and the counts, neither
    materialised (the port's model on the meta device)."""
    monkeypatch.setattr(torch, "Generator", _CPUGenerator)
    over = {} if n_layers == 100 else {"n_layers": 2, "cross_every": 2}
    rcfg = dataclasses.replace(ref_registry.get_config(ARCH), **over)
    shapes = jax.eval_shape(ref_registry.build(rcfg).init,
                            jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
    model = build(dataclasses.replace(get_config(ARCH), **over),
                  device="meta")
    assert isinstance(model, VisionLM)
    got = {k: tuple(v.shape) for k, v in model.params().items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == want_count


# ---------------------------------------------------------------------------
# the pieces: cross attention (GQA), the 0-d gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    cfg = get_config(ARCH).reduced()
    rp = jax.tree.map(lambda a: a[0],
                      _ref_init()["supers"]["crossb"]["xattn"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    img = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    a = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
             head_dim=cfg.hd, use_rope=False, causal=False)
    assert cfg.n_kv_heads < cfg.n_heads
    want, _ = ref_cm.attention(RefTape(), "x", "p",
                               jax.tree.map(jnp.asarray, rp),
                               jnp.asarray(x, dtype), ref_cm.AttnCfg(**a),
                               kv_x=jnp.asarray(img, dtype))
    p = {k: torch.from_numpy(np.array(v))
         for k, v in flatten_tree(rp).items()}
    td = getattr(torch, dtype)
    got = cm.cross_attention(Tape(), "x", "p", p, torch.from_numpy(x).to(td),
                             torch.from_numpy(img).to(td), cm.AttnCfg(**a))
    assert got.dtype == td
    _close(got, np.asarray(want.astype(jnp.float32)),
           2e-6 if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("stack", [(), ("layers",)])
def test_zero_dim_scale_companions_match_reference(stack):
    """The gate: a 0-d ``scale`` (gdim 0) alone and under a layer stack;
    its per-example squared norm sums every non-batch axis into a (B,)
    norm, and BK gives a () grad per layer, not a broadcast."""
    rng = np.random.default_rng(5)
    lead = (3,) if stack else ()
    x = rng.standard_normal(lead + (B, 6, 8)).astype(np.float32)
    dy = rng.standard_normal(lead + (B, 6, 8)).astype(np.float32)
    coef = np.array([0.5, 0.0, 1.25, 1.0], np.float32)
    meta = (("gdim", 0),)
    rspec = ref_layers.LayerSpec("scale", stack=stack, param_path="g",
                                 meta=meta)
    spec = LayerSpec("scale", stack=stack, param_path="g", meta=meta)

    def port(a):
        a = torch.from_numpy(a)
        return list(a) if stack else a

    want = ref_layers.per_example_sq_norm(rspec, {"x": jnp.asarray(x)},
                                          jnp.asarray(dy))
    got = L.per_example_sq_norm(spec, {"x": port(x)}, port(dy))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    rbk = ref_layers.bk_grads(rspec, {"x": jnp.asarray(x)}, jnp.asarray(dy),
                              jnp.asarray(coef))["g"]
    tbk = L.bk_grads(spec, {"x": port(x)}, port(dy),
                     torch.from_numpy(coef))["g"]
    assert tuple(tbk.shape) == lead == tuple(np.shape(rbk))
    _close(tbk, rbk, 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_example_losses_grads_and_norms_match_reference(dtype):
    rmodel, rparams, rbatch, model, params, batch = _pair(dtype)
    want_l = np.asarray(jax.jit(lambda p, b: rmodel.loss(p, b, RefTape()))(
        rparams, rbatch))
    np.testing.assert_allclose(model.loss(params, batch).numpy(), want_l,
                               rtol=0, atol=TOL[dtype][0])
    rgrads, rsq = jax.jit(lambda p, b: ref_pe(
        lambda pp, bb, t: rmodel.loss(pp, bb, t), p, b))(rparams, rbatch)
    grads, sq = per_example_grads_and_sq(model.loss, params, batch)
    assert grads[GATE].shape == (B, 1)
    _hold(grads, rgrads, TOL[dtype][1])
    np.testing.assert_allclose(sq.numpy(), np.asarray(rsq),
                               rtol=TOL[dtype][1])


def test_logits_match_reference():
    rmodel, rparams, rbatch, model, params, batch = _pair()
    fresh = build(model.cfg, device="cpu")
    fresh.load_state_dict(params)
    want = jax.jit(lambda p, b: rmodel.logits(
        p, b["tokens"], b["frontend"], RefTape()))(rparams, rbatch)
    _close(fresh.logits(batch["tokens"], batch["frontend"]), want, 2e-6)


@functools.lru_cache(maxsize=None)
def _ref_engines():
    """Every engine's clipped sum and aux on the reference, in one
    ``jit``; the stream at a tile of 3 below the batch of 4."""
    rmodel, rparams, rbatch, *_ = _pair()

    def run(p, b, m):
        return {e: ref_clipping.ENGINES[e](
            lambda pp, bb, t: rmodel.loss(pp, bb, t), p, b, m, 1.0,
            **({"tile": 3} if e == "masked_fused_stream" else {}))
            for e in ENGINES}
    return jax.jit(run)(rparams, rbatch, jnp.asarray(MASK))


@pytest.mark.parametrize("engine", ENGINES)
def test_engines_match_reference(engine):
    *_, model, params, batch = _pair()
    rsum, raux = _ref_engines()[engine]
    kw = {"tile": 3} if engine == "masked_fused_stream" else {}
    if engine == "masked_bk":
        kw = {"check_coverage": True}
    tsum, taux = clipping.resolve_engine(engine)(
        model.loss, params, batch, torch.from_numpy(MASK), 1.0, **kw)
    assert list(tsum) == list(params)
    _hold(tsum, rsum, 2e-5)
    np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                               np.asarray(raux["per_example_norms"]),
                               rtol=2e-5)
    np.testing.assert_allclose(taux["clip_coef"].numpy(),
                               np.asarray(raux["clip_coef"]), rtol=0,
                               atol=2e-5)
    assert float(taux["clip_coef"][2]) == 0.0


def _stacked(a):
    return torch.stack([_stacked(v) for v in a]) if isinstance(a, list) \
        else a


def test_tape_nests_stacks_as_the_reference_does():
    """Specs in the reference's insertion order with its kinds, stacks
    (('layers', 'layers') for ``supers.selfb``, ('layers',) for
    ``supers.crossb`` and the gate), parameter paths and metas (the gate's
    gdim 0); dY stack to the reference's eps shapes; every cross layer's
    ``wk``/``wv`` records the one projected image tensor."""
    rmodel, rparams, rbatch, model, params, batch = _pair()
    rtape = RefTape(RefTape.COLLECT)
    jax.eval_shape(lambda p, b: rmodel.loss(p, b, rtape), rparams, rbatch)
    dEps, records, specs, _ = clipping._eps_backward(model.loss, params,
                                                     batch)
    assert list(specs) == list(rtape.specs)
    for n, spec in specs.items():
        rs = rtape.specs[n]
        assert (spec.kind, spec.stack, spec.param_path, spec.meta) == (
            rs.kind, rs.stack, rs.param_path, rs.meta), n
        assert tuple(_stacked(dEps[n]).shape) == rtape.eps[n].shape, n
    assert specs["supers/selfb/attn.wq"].stack == ("layers", "layers")
    assert specs["supers/gate"].meta == (("gdim", 0),)
    assert specs["supers/gate"].stack == ("layers",)
    xs = records["supers/xattn.wk"]["x"] + records["supers/xattn.wv"]["x"]
    assert all(x.data_ptr() == xs[0].data_ptr() for x in xs)
    assert xs[0].shape == (B, model.cfg.n_image_tokens, model.cfg.d_model)


def test_forced_direct_path_matches_the_gram_path(monkeypatch):
    """Every dense layer's per-example norm through the kernel's wrapper
    (the plain ``ghost_norm_dense`` on the CPU) against the Gram path,
    ``proj`` and the cross attention's wk/wv (S = 8 image tokens for T =
    16 queries) among them."""
    *_, model, params, batch = _pair()
    dEps, records, specs, _ = clipping._eps_backward(model.loss, params,
                                                     batch)
    denses = [n for n, s in specs.items() if s.kind == "dense"]
    assert {"proj", "supers/xattn.wk", "supers/selfb/attn.wq",
            "head"} <= set(denses)
    for name in denses:
        spec = specs[name]
        rec = L.resolve_record(records, name, spec)
        out = {}
        for path in ("direct", "ghost"):
            monkeypatch.setattr(L, "_FORCE_PATH", path)
            out[path] = L.per_example_sq_norm(spec, rec, dEps[name])
        np.testing.assert_allclose(out["direct"].numpy(),
                                   out["ghost"].numpy(), rtol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

TRAIN = dict(steps=2, n_data=32, seq_len=16, physical_batch=4, q=0.25,
             target_eps=8.0, lr=0.5, seed=0, smoke=True)


def _reference_noise(ref, steps):
    view = RefView.for_tree(ref.state.params)
    key, out = ref.state.rng, []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.asarray(view.noise(nkey)))
    return out


def test_fit_matches_reference():
    """2 steps through book-keeping (the gate's BK grad a () per super,
    stacked to the (n_super,) leaf), the reference's noise fed in as the
    update's operand, the gates opened on both sides."""
    engine = "masked_bk"
    ref = RefSession.from_config(
        ARCH, RefDPConfig(engine=engine, clip_norm=1.0),
        RefTrainConfig(**TRAIN))
    p0 = _open_gates(ref.state.params, 12)
    ref.state = ref.state._replace(params=jax.tree.map(jnp.asarray, p0))
    noise = _reference_noise(ref, TRAIN["steps"])
    ref_out = ref.fit()
    port = PrivacySession.from_config(
        ARCH, DPConfig(engine=engine, clip_norm=1.0), TrainConfig(**TRAIN),
        device="cpu", params=params_from_numpy(p0, "cpu"))
    out = port.fit(noise=lambda k: torch.tensor(noise[k]))
    assert out["sigma"].hex() == ref_out["sigma"].hex()
    assert float(out["final_eps"]).hex() == float(ref_out["final_eps"]).hex()
    assert len(out["history"]) == len(ref_out["history"]) == 2
    for got, want in zip(out["history"], ref_out["history"]):
        assert got["logical_batch"] == want["logical_batch"]
        assert got["eps"] == want["eps"]
        assert got["loss"] == pytest.approx(want["loss"], abs=1e-3)
    want = flatten_tree(jax.tree.map(np.asarray, ref.state.params))
    scale = max(float(np.abs(v).max()) for v in want.values())
    start = flatten_tree(p0)
    for k, w in want.items():
        np.testing.assert_allclose(port.state.params[k].numpy(), w, rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    for k in (GATE, "proj.w"):
        assert float(np.abs(want[k] - start[k]).max()) > 1e-4, k
    np.testing.assert_allclose(port.state.opt_state["mom"].numpy(),
                               np.asarray(ref.state.opt_state["mom"]),
                               rtol=0, atol=1e-5 * scale)


def test_checkpoint_round_trip(tmp_path):
    """A 1-step fit from opened gates, checkpointed and restored in a fresh
    session: params (the nested ``supers.selfb`` leaves and the gate),
    momentum, the step and ε come back bit for bit."""
    d = str(tmp_path / "ck")
    train = TrainConfig(**dict(TRAIN, steps=1))
    dp = DPConfig(engine="masked_ghost", clip_norm=1.0)
    s1 = PrivacySession.from_config(ARCH, dp, train, device="cpu",
                                    params=params_from_numpy(_ref_init(),
                                                             "cpu"))
    s1.fit(ckpt=d)
    s2 = PrivacySession.restore(d, ARCH, dp, train, device="cpu")
    assert s2.state.step == 1
    assert list(s2.state.params) == list(s1.state.params)
    for k, p in s1.state.params.items():
        assert torch.equal(s2.state.params[k], p), k
    assert float(s2.state.params[GATE].abs().min()) >= 0.4
    assert torch.equal(s2.state.opt_state["mom"], s1.state.opt_state["mom"])
    assert float(s2.privacy_spent()[0]).hex() == \
        float(s1.privacy_spent()[0]).hex()


def test_cli_trains_the_vlm():
    from repro_torch.launch import train
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--seq-len", "16", "--steps", "1", "--n-data", "16",
                      "--physical", "4", "--q", "0.25", "--engine",
                      "masked_fused_stream"])
    assert out["history"] and np.isfinite(out["history"][0]["loss"])
