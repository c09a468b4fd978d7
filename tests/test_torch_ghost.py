"""The port's record-mode tape, layer companions and ghost/book-keeping
engines against the reference's, on inputs made from a seed with numpy.

Tolerances (f32 unless stated):
* ``per_example_sq_norm``: 1e-5 relative; ``bk_grads``: 1e-5 of the
  largest entry.  Both sides do the same products and reductions in another
  order (BK's sums over examples are einsums on both sides, not a fold).
* ``ghost_norm_dense`` plain version against the reference's kernel
  (interpret mode) and ``ghost_norm_dense_ref``: 1e-5 relative.
* Reduced ViT with the reference's weights: ghost squared norms 2e-5
  relative in f32 (measured 5.9e-7) and 2e-2 in bf16 (measured 7.4e-3: the
  dY are bf16 and a bf16 step rounded the other way moves a norm by one
  bf16 ULP); ``masked_ghost``/``masked_bk`` sums 2e-5 of the largest entry
  (measured 7.7e-7), norms 2e-5 relative, clip coefficients 2e-5 absolute;
  against the port's own ``masked_pe`` 1e-5 of the largest entry (measured
  6.8e-7 and 8.5e-8).  Ghost norms against the port's per-example oracle:
  3e-4 relative, the reference's own test bound (measured 1.1e-7); the
  forced direct and ghost paths against the Mixed-Ghost choice: 1e-5.
* The toy model with an embedding, a layer stack with a re-used
  (``shared/``) dense, a conv and a head: as the reduced ViT against the
  reference, and 2e-3 relative against the port's ``masked_pe`` (the
  reference's own test bound).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vit_base import CONFIG as REF_VIT
from repro.core import clipping as ref_clipping
from repro.core import layers as ref_layers
from repro.core.tape import LayerSpec as RefSpec
from repro.core.tape import Tape as RefTape
from repro.core.tape import scan_blocks as ref_scan_blocks
from repro.kernels.ghost_norm import ghost_norm_dense as ref_ghost_kernel
from repro.kernels.ref import ghost_norm_dense_ref
from repro.models.registry import build as ref_build
from repro_torch.configs import get_config
from repro_torch.core import clipping
from repro_torch.core import layers as L
from repro_torch.core.tape import LayerSpec, Tape, scan_blocks
from repro_torch.kernels import ghost_norm as gn
from repro_torch.models import build
from repro_torch.utils.params import flatten_tree, params_from_numpy

# --------------------------------------------------------------------------
# per primitive: per_example_sq_norm and bk_grads
# --------------------------------------------------------------------------

# name -> (kind, meta, stack, record shapes, dY shape); B = 3, L/U = 2
CASES = {
    "dense_bias_ghost": ("dense", (("has_bias", True),), (),
                         {"x": (3, 4, 6)}, (3, 4, 5)),
    "dense_direct": ("dense", (("has_bias", False),), (),
                     {"x": (3, 9, 4)}, (3, 9, 5)),
    "dense_bias_t1": ("dense", (("has_bias", True),), (),
                      {"x": (3, 6)}, (3, 5)),
    "dense_layers": ("dense", (("has_bias", True),), ("layers",),
                     {"x": (2, 3, 4, 6)}, (2, 3, 4, 5)),
    "dense_uses": ("dense", (("has_bias", False),), ("uses",),
                   {"x": (2, 3, 4, 6)}, (2, 3, 4, 5)),
    "embed": ("embed", (("vocab", 7),), (), {"ids": (3, 5)}, (3, 5, 4)),
    "embed_layers": ("embed", (("vocab", 7),), ("layers",),
                     {"ids": (2, 3, 5)}, (2, 3, 5, 4)),
    "scale": ("scale", (("gdim", 1),), (), {"x": (3, 4, 6)}, (3, 4, 6)),
    "scale_layers": ("scale", (("gdim", 1),), ("layers",),
                     {"x": (2, 3, 4, 6)}, (2, 3, 4, 6)),
    "bias": ("bias", (("bdim", 1),), (), {}, (3, 4, 6)),
    "bias_bdim2": ("bias", (("bdim", 2),), (), {}, (3, 4, 6)),
    "conv1d": ("conv1d", (("width", 4),), (), {"x": (3, 7, 5)}, (3, 7, 5)),
    "conv1d_layers": ("conv1d", (("width", 4),), ("layers",),
                      {"x": (2, 3, 7, 5)}, (2, 3, 7, 5)),
}
DENSE = [n for n in CASES if n.startswith("dense")]
PARAMS = ([(n, None) for n in CASES]
          + [(n, f) for n in DENSE for f in ("ghost", "direct")])


def _case(name, seed=0):
    kind, meta, stack, rec_shapes, dy_shape = CASES[name]
    rng = np.random.default_rng(seed)
    rec = {k: (rng.integers(0, 7, s).astype(np.int32) if k == "ids"
               else rng.standard_normal(s).astype(np.float32))
           for k, s in rec_shapes.items()}
    dy = rng.standard_normal(dy_shape).astype(np.float32)
    coef = rng.random(3).astype(np.float32)
    coef[1] = 0.0
    return kind, meta, stack, rec, dy, coef


@pytest.mark.parametrize("name,force", PARAMS)
def test_companions_match_reference(name, force, monkeypatch):
    kind, meta, stack, rec, dy, coef = _case(name)
    monkeypatch.setattr(L, "_FORCE_PATH", force)
    monkeypatch.setattr(ref_layers, "_FORCE_PATH", force)
    rspec = RefSpec(kind, stack=stack, param_path="p", meta=meta)
    tspec = LayerSpec(kind, stack=stack, param_path="p", meta=meta)
    rrec = {k: jnp.asarray(v) for k, v in rec.items()}
    trec = {k: torch.from_numpy(v) for k, v in rec.items()}
    want = np.asarray(ref_layers.per_example_sq_norm(rspec, rrec,
                                                     jnp.asarray(dy)))
    got = L.per_example_sq_norm(tspec, trec, torch.from_numpy(dy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    rbk = ref_layers.bk_grads(rspec, rrec, jnp.asarray(dy), jnp.asarray(coef))
    tbk = L.bk_grads(tspec, trec, torch.from_numpy(dy), torch.from_numpy(coef))
    assert set(tbk) == set(rbk)
    for k, w in rbk.items():
        w = np.asarray(w)
        np.testing.assert_allclose(tbk[k].numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)


def test_t1_dense_takes_the_kernel_even_when_ghost_is_forced(monkeypatch):
    """``use_ghost and T > 1``: a T = 1 dense (the ViT head) always runs
    the direct path, the ghost_norm_dense wrapper."""
    calls = []
    monkeypatch.setattr(L, "ghost_norm_dense",
                        lambda x, d: calls.append(x.shape)
                        or gn.ghost_norm_dense(x, d))
    _, _, _, rec, dy, _ = _case("dense_bias_t1")
    for force in (None, "ghost"):
        monkeypatch.setattr(L, "_FORCE_PATH", force)
        L.per_example_sq_norm(LayerSpec("dense", meta=(("has_bias", True),)),
                              {"x": torch.from_numpy(rec["x"])},
                              torch.from_numpy(dy))
    assert calls == [(3, 1, 6), (3, 1, 6)]


def test_bf16_records_reach_the_kernel_unconverted(monkeypatch):
    """The direct path hands bf16 records and dY to the kernel as they are
    (it upcasts per element): the same norms as the reference's f32 call."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4)).astype(
        np.float32)).bfloat16()
    dy = torch.from_numpy(rng.standard_normal((2, 9, 5)).astype(
        np.float32)).bfloat16()
    seen = []
    monkeypatch.setattr(L, "ghost_norm_dense",
                        lambda a, b: seen.append((a.dtype, b.dtype))
                        or gn.ghost_norm_dense(a, b))
    got = L.per_example_sq_norm(LayerSpec("dense"), {"x": x}, dy)
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    want = ref_layers.per_example_sq_norm(
        RefSpec("dense"), {"x": jnp.asarray(x.float().numpy(), jnp.bfloat16)},
        jnp.asarray(dy.float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# --------------------------------------------------------------------------
# ghost_norm_dense: the plain version against the reference kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 7, 20, 13), (2, 1, 16, 5),
                                   (2, 33, 9, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ghost_norm_dense_plain_matches_reference(shape, dtype):
    B, T, di, do = shape
    rng = np.random.default_rng(T)
    x = rng.standard_normal((B, T, di)).astype(np.float32)
    dy = rng.standard_normal((B, T, do)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    dt = torch.from_numpy(dy).to(getattr(torch, dtype))
    got = gn.ghost_norm_dense(xt, dt).numpy()
    xf, df = jnp.asarray(xt.float().numpy()), jnp.asarray(dt.float().numpy())
    kern = np.asarray(ref_ghost_kernel(
        xf, df, interpret=True, tiles=ref_layers._norm_tiles(T, di, do)))
    np.testing.assert_allclose(got, kern, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ghost_norm_dense_ref(xf, df)),
                               rtol=1e-5)
    assert gn.n_tiles(di, do) == -(-di // 64) * -(-do // 64)


@pytest.mark.parametrize("x,dy,exc", [
    (torch.zeros(2, 3), torch.zeros(2, 3), ValueError),
    (torch.zeros(2, 3, 4), torch.zeros(2, 4, 4), ValueError),
    (torch.zeros(2, 3, 4), torch.zeros(2, 3, 4, dtype=torch.bfloat16),
     TypeError),
    (torch.zeros(2, 3, 4, dtype=torch.float64),
     torch.zeros(2, 3, 4, dtype=torch.float64), TypeError),
    (torch.zeros(2, 4, 3).transpose(1, 2), torch.zeros(2, 3, 4), ValueError),
    (torch.zeros(2, 3, 4, device="meta"), torch.zeros(2, 3, 4), ValueError),
])
def test_ghost_norm_dense_rejects_bad_operands(x, dy, exc):
    with pytest.raises(exc):
        gn.ghost_norm_dense(x, dy)


# --------------------------------------------------------------------------
# the reduced ViT with the reference's weights
# --------------------------------------------------------------------------

B = 6
MASK = np.array([1, 1, 0, 1, 1, 1], np.float32)


@functools.lru_cache(maxsize=None)
def _vit(dtype="float32"):
    rmodel = ref_build(REF_VIT.reduced(dtype=dtype))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build(get_config("vit-base").reduced(dtype=dtype), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 100, B).astype(np.int32)
    return (lambda p, b, t: rmodel.loss(p, b, t), rparams,
            {"image": jnp.asarray(x), "label": jnp.asarray(y)},
            model.loss, params,
            {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_vit_ghost_norms_match_reference(dtype, rtol):
    rloss, rparams, rbatch, loss, params, batch = _vit(dtype)
    want, wl = ref_clipping.ghost_norms(rloss, rparams, rbatch)
    got, gl = clipping.ghost_norms(loss, params, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0,
                               atol=rtol)


def test_vit_ghost_norms_match_the_per_example_oracle():
    _, _, _, loss, params, batch = _vit()
    sq, _ = clipping.ghost_norms(loss, params, batch)
    oracle = clipping.per_example_grad_norms(loss, params, batch)
    torch.testing.assert_close(torch.sqrt(sq), oracle, rtol=3e-4, atol=0)


@pytest.mark.parametrize("force", ["direct", "ghost"])
def test_vit_forced_paths_agree(force, monkeypatch):
    """Every dense on the ghost path, or every dense through the kernel's
    wrapper (14 calls on the reduced ViT: patch, 2 x 6 block denses,
    head)."""
    _, _, _, loss, params, batch = _vit()
    mixed, _ = clipping.ghost_norms(loss, params, batch)
    calls = []
    monkeypatch.setattr(L, "ghost_norm_dense",
                        lambda x, d: calls.append(1)
                        or gn.ghost_norm_dense(x, d))
    monkeypatch.setattr(L, "_FORCE_PATH", force)
    forced, _ = clipping.ghost_norms(loss, params, batch)
    torch.testing.assert_close(forced, mixed, rtol=1e-5, atol=0)
    assert len(calls) == (14 if force == "direct" else 1)


def test_vit_tape_records_in_reference_order():
    """Specs in the tape's insertion order (patch, cls, pos, blocks/...,
    lnf, head: the order the norms are summed in), with the reference's
    kinds, stacks and parameter paths; dY in the activation dtype.  A layer
    stack's records and dY are lists of the per-layer tensors, which stacked
    have the reference's shapes; the block records that hold one tensor
    (``h`` into wq, wk and wv) share it."""
    rloss, rparams, rbatch, loss, params, batch = _vit("bfloat16")
    rtape = RefTape(RefTape.COLLECT)
    jax.eval_shape(lambda p, b: rloss(p, b, rtape), rparams, rbatch)
    dEps, records, specs, _ = clipping._eps_backward(loss, params, batch)
    assert list(specs) == list(rtape.specs)

    def stacked(v):
        return torch.stack(v) if spec.stack else v

    for name, spec in specs.items():
        rs = rtape.specs[name]
        assert (spec.kind, spec.stack, spec.param_path, spec.meta) == (
            rs.kind, rs.stack, rs.param_path, rs.meta), name
        assert isinstance(dEps[name], list) == bool(spec.stack), name
        assert tuple(stacked(dEps[name]).shape) == rtape.eps[name].shape, name
        assert stacked(dEps[name]).dtype == torch.bfloat16, name
        for k, v in records[name].items():
            assert tuple(stacked(v).shape) == rtape.records[name][k].shape, (
                name, k)
    for a, b in zip(records["blocks/attn.wq"]["x"],
                    records["blocks/attn.wv"]["x"]):
        assert a.data_ptr() == b.data_ptr()


@pytest.mark.parametrize("engine", ["masked_ghost", "masked_bk"])
def test_vit_record_engines_match_reference(engine):
    rloss, rparams, rbatch, loss, params, batch = _vit()
    rsum, raux = ref_clipping.ENGINES[engine](rloss, rparams, rbatch,
                                              jnp.asarray(MASK), 1.0)
    kw = {"check_coverage": True} if engine == "masked_bk" else {}
    tsum, taux = clipping.resolve_engine(engine)(
        loss, params, batch, torch.from_numpy(MASK), 1.0, **kw)
    want = flatten_tree(jax.tree.map(np.asarray, rsum))
    assert list(tsum) == list(params) and set(want) == set(tsum)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        assert tsum[name].dtype == torch.float32
        np.testing.assert_allclose(tsum[name].numpy(), w, rtol=0,
                                   atol=2e-5 * scale, err_msg=name)
    np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                               np.asarray(raux["per_example_norms"]),
                               rtol=2e-5)
    np.testing.assert_allclose(taux["clip_coef"].numpy(),
                               np.asarray(raux["clip_coef"]), rtol=0,
                               atol=2e-5)
    assert float(taux["clip_coef"][2]) == 0.0


@pytest.mark.parametrize("engine", ["masked_ghost", "masked_bk"])
def test_vit_record_engines_match_port_masked_pe(engine):
    _, _, _, loss, params, batch = _vit()
    mask = torch.from_numpy(MASK)
    pe, _ = clipping.resolve_engine("masked_pe")(loss, params, batch, mask,
                                                 1.0)
    got, _ = clipping.resolve_engine(engine)(loss, params, batch, mask, 1.0)
    scale = max(float(v.abs().max()) for v in pe.values())
    for name in pe:
        torch.testing.assert_close(got[name], pe[name], rtol=0,
                                   atol=1e-5 * scale)


# --------------------------------------------------------------------------
# a toy model through every primitive, a layer stack and a re-used dense
# --------------------------------------------------------------------------

V, D, T, NL = 13, 8, 5, 3


def _ref_toy_loss(params, batch, tape):
    x = ref_layers.embed(tape, "emb", batch["tokens"], params["emb"]["w"],
                         param_path="emb.w")

    def body(sub, p, x):
        h = ref_layers.dense(sub, "fc", x, p["fc"]["w"], p["fc"]["b"],
                             param_path="blocks.fc")
        h = ref_layers.scale(sub, "g", jnp.tanh(h), p["g"]["w"],
                             param_path="blocks.g.w")
        h = h + ref_layers.dense(sub, "shared/sd", x, params["shared"]["w"],
                                 param_path="shared")
        return jnp.tanh(h)

    x = ref_scan_blocks(tape, "blocks", body, params["blocks"], x, NL)
    x = ref_layers.conv1d_depthwise(tape, "cv", x, params["cv"]["w"],
                                    param_path="cv.w")
    logits = ref_layers.dense(tape, "head", x, params["head"]["w"],
                              param_path="head")
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    ll = jnp.take_along_axis(logp, batch["labels"][..., None], -1)[..., 0]
    return -ll.mean(axis=-1)


def _toy_loss(params, batch, tape=None):
    tape = Tape() if tape is None else tape
    x = L.embed(tape, "emb", batch["tokens"], params["emb.w"],
                param_path="emb.w")

    def body(sub, p, x):
        h = L.dense(sub, "fc", x, p["fc.w"], p["fc.b"], param_path="blocks.fc")
        h = L.scale(sub, "g", torch.tanh(h), p["g.w"], param_path="blocks.g.w")
        h = h + L.dense(sub, "shared/sd", x, params["shared.w"],
                        param_path="shared")
        return torch.tanh(h)

    stacked = {k[len("blocks."):]: v for k, v in params.items()
               if k.startswith("blocks.")}
    x = scan_blocks(tape, "blocks", body, stacked, x, NL)
    x = L.conv1d_depthwise(tape, "cv", x, params["cv.w"], param_path="cv.w")
    logits = L.dense(tape, "head", x, params["head.w"], param_path="head")
    logp = torch.log_softmax(logits.float(), -1)
    ll = torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    return -ll.mean(dim=-1)


@functools.lru_cache(maxsize=None)
def _toy():
    rng = np.random.default_rng(5)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    rparams = {"emb": {"w": n(V, D) * 0.3},
               "blocks": {"fc": {"w": n(NL, D, D) * 0.3, "b": n(NL, D) * 0.1},
                          "g": {"w": n(NL, D) * 0.2 + 1.0}},
               "shared": {"w": n(D, D) * 0.3},
               "cv": {"w": n(4, D) * 0.2},
               "head": {"w": n(D, V) * 0.3}}
    batch = {"tokens": rng.integers(0, V, (4, T)).astype(np.int32),
             "labels": rng.integers(0, V, (4, T)).astype(np.int32)}
    return (jax.tree.map(jnp.asarray, rparams),
            {k: jnp.asarray(v) for k, v in batch.items()},
            params_from_numpy(rparams, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("force", [None, "direct"])
def test_toy_ghost_norms_match_oracle_and_reference(force, monkeypatch):
    rparams, rbatch, params, batch = _toy()
    monkeypatch.setattr(L, "_FORCE_PATH", force)
    monkeypatch.setattr(ref_layers, "_FORCE_PATH", force)
    sq, _ = clipping.ghost_norms(_toy_loss, params, batch)
    want, _ = ref_clipping.ghost_norms(_ref_toy_loss, rparams, rbatch)
    np.testing.assert_allclose(sq.numpy(), np.asarray(want), rtol=2e-5)
    oracle = clipping.per_example_grad_norms(_toy_loss, params, batch)
    torch.testing.assert_close(torch.sqrt(sq), oracle, rtol=3e-4, atol=0)


def test_toy_tape_stacks_layers_and_uses():
    _, _, params, batch = _toy()
    _, records, specs, _ = clipping._eps_backward(_toy_loss, params, batch)
    assert specs["blocks/fc"].stack == ("layers",)
    assert specs["blocks/shared/sd"].stack == ("uses",)
    assert specs["emb"].stack == ()
    sd = records["blocks/shared/sd"]["x"]
    assert len(sd) == NL and all(tuple(x.shape) == (4, T, D) for x in sd)


@pytest.mark.parametrize("engine", ["masked_ghost", "masked_bk"])
def test_toy_record_engines_match_pe_and_reference(engine):
    rparams, rbatch, params, batch = _toy()
    mask = np.array([1, 1, 0, 1], np.float32)
    pe, _ = clipping.resolve_engine("masked_pe")(
        _toy_loss, params, batch, torch.from_numpy(mask), 0.05)
    got, _ = clipping.resolve_engine(engine)(
        _toy_loss, params, batch, torch.from_numpy(mask), 0.05)
    rsum, _ = ref_clipping.ENGINES[engine](_ref_toy_loss, rparams, rbatch,
                                           jnp.asarray(mask), 0.05)
    want = flatten_tree(jax.tree.map(np.asarray, rsum))
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), pe[name].numpy(),
                                   rtol=2e-3, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=2e-5 * scale, err_msg=name)


def test_bk_check_coverage_names_the_missing_parameter():
    _, _, params, batch = _toy()
    extra = dict(params, **{"extra.w": torch.zeros(3)})
    mask = torch.ones(4)
    with pytest.raises(ValueError, match="extra.w"):
        clipping.resolve_engine("masked_bk")(_toy_loss, extra, batch, mask,
                                             0.05, check_coverage=True)
    summed, _ = clipping.resolve_engine("masked_bk")(_toy_loss, extra, batch,
                                                     mask, 0.05)
    assert torch.equal(summed["extra.w"], torch.zeros(3))
    clipping.resolve_engine("masked_bk")(_toy_loss, params, batch, mask,
                                         0.05, check_coverage=True)


def test_plain_tape_records_nothing_and_names_are_unique():
    tape = Tape()
    y = L.dense(tape, "d", torch.ones(2, 3), torch.ones(3, 4),
                param_path="d")
    assert not tape.specs and not tape.records and not tape.eps
    rec = Tape(Tape.RECORD)
    L.dense(rec, "d", torch.ones(2, 3), torch.ones(3, 4), param_path="d")
    assert torch.equal(rec.eps["d"], torch.zeros(2, 4))
    assert rec.eps["d"].requires_grad
    with pytest.raises(ValueError, match="duplicate"):
        L.dense(rec, "d", torch.ones(2, 3), torch.ones(3, 4), param_path="d")
    assert torch.equal(y, torch.full((2, 4), 3.0))
