"""The port's Whisper encoder-decoder (``models/whisper.py``,
``models/common.py``'s ``cross_attention``, ``EmbeddingDataset``) against
the reference's, with the reference's weights carried over by
``params_from_numpy`` and inputs made from a numpy seed.

Model: reduced whisper-base (2 encoder and 2 decoder layers, d 128, 4
heads of 32, d_ff 256, vocab 97, 12 frames; f32 unless stated).  At 12
frames and 16 tokens every dense takes the Gram path; the direct-path case
runs 192 frames, where T^2 = 36,864 exceeds din dout for every encoder
dense (128 x 128, 128 x 256) and for the decoder's cross-attention
``wk``/``wv``, whose records are the encoder's frames: 8 kernel calls per
layer pair, as full width's 48 at 1,500 frames (6 x 6 + 6 x 2).

Tolerances:
* ``EmbeddingDataset``: bitwise.
* ``sinusoid``: over positions 0..1,499 at d 512 and 128, each entry
  within 4 ULPs of its angle plus 2^-21.  XLA:CPU's ``exp`` and PyTorch's
  round 25 of the 256 frequencies the other way (1 ULP); times a position
  up to 1,499 and rounded, the angle moves by up to 2 of its own ULPs
  (measured 2.0 ULPs: 1.2e-4 at position 1,398, where an angle's ULP is
  1.2e-4), and ``sin``/``cos`` carry that over.  Relative to the bf16
  frames the table is added to (a bf16 step at 1 is 7.8e-3) it is
  noise.
* ``cross_attention``: f32 2e-6 of the largest output (measured 2.4e-7);
  bf16 2^-7 of it, one bf16 step (measured 0).
* per-example losses, grads and squared norms: f32 2e-5 (grads of the
  largest entry; measured 4.8e-7 / 3.2e-7 / 2.4e-7); bf16 at DenseLM's
  bounds 2e-2 / 5e-2 / 5e-2 (measured 1.9e-3 / 4.7e-3 / 7.5e-4).
* every engine's clipped sum against the reference's: 2e-5 of the largest
  entry; norms 2e-5 relative; clip coefficients 2e-5 absolute.
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
from repro.core.clipping import per_example_grads_and_sq as ref_pe
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.core.tape import Tape as RefTape
from repro.data.synthetic import dataset_for_config as ref_dataset
from repro.models import common as ref_cm
from repro.models import registry as ref_registry
from repro.models import whisper as ref_whisper
from repro.utils.params import FlatGradView as RefView
from repro_torch.configs import get_config
from repro_torch.core import DPConfig, clipping
from repro_torch.core import layers as L
from repro_torch.core.clipping import per_example_grads_and_sq
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.core.tape import Tape
from repro_torch.data import EmbeddingDataset, dataset_for_config
from repro_torch.kernels import ghost_norm as gn
from repro_torch.models import WhisperLM, build
from repro_torch.models import common as cm
from repro_torch.models import whisper
from repro_torch.utils.params import (FlatGradView, flatten_tree,
                                      params_from_numpy)

ARCH = "whisper-base"
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 5e-2)}
B, T = 4, 16
MASK = np.array([1, 0, 1, 1], np.float32)
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


@functools.lru_cache(maxsize=None)
def _ref_init():
    rmodel = ref_registry.build(ref_registry.get_config(ARCH).reduced())
    return jax.tree.map(np.asarray,
                        jax.jit(rmodel.init)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32", frames=None, seed=0):
    """The reference's model, params and batch, and the port's, with the
    reference's weights (initialised under ``jit``)."""
    over = {"dtype": dtype}
    if frames:
        over["n_audio_frames"] = frames
    rcfg = ref_registry.get_config(ARCH).reduced(**over)
    cfg = get_config(ARCH).reduced(**over)
    rmodel = ref_registry.build(rcfg)
    rparams = jax.tree.map(jnp.asarray, _ref_init())
    model = build(cfg, device="cpu")
    params = params_from_numpy(_ref_init(), "cpu")
    rng = np.random.default_rng(seed)
    front = rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)).astype(
        np.float32)
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
    want = flatten_tree(jax.tree.map(np.asarray, rtree))
    assert set(want) == set(got)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].detach().float().numpy(), w,
                                   rtol=0, atol=tol * scale, err_msg=name)


# ---------------------------------------------------------------------------
# config, data, weights
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    port, ref = get_config(ARCH), ref_registry.get_config(ARCH)
    for cfg, rcfg in ((port, ref), (port.reduced(), ref.reduced())):
        for f in dataclasses.fields(rcfg):
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name


def test_embedding_dataset_matches_reference():
    """The same seed gives the same frames, tokens and labels, bit for
    bit: ``n_audio_frames`` frames of ``d_model``."""
    cfg = get_config(ARCH).reduced()
    ds = dataset_for_config(cfg, 20, 9, seed=4)
    ref = ref_dataset(ref_registry.get_config(ARCH).reduced(), 20, 9, seed=4)
    assert isinstance(ds, EmbeddingDataset)
    idx = np.array([3, 0, 19, 3])
    got, want = ds.fetch(idx), ref.fetch(idx)
    assert set(got) == set(want) == {"frontend", "tokens", "labels"}
    assert got["frontend"].shape == (4, cfg.n_audio_frames, cfg.d_model)
    assert got["frontend"].dtype == np.float32
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_weights_carry_over_in_flatten_order():
    """The port model's own leaves are the reference's, by name, order and
    shape, and FlatGradView puts every reference leaf at the reference's
    offset (dec_blocks < dec_lnf < emb < enc_blocks < enc_lnf < head)."""
    _, rparams, _, model, params, _ = _pair()
    leaves, _ = jax.tree_util.tree_flatten_with_path(rparams)
    names = [".".join(k.key for k in path) for path, _ in leaves]
    own = model.params()
    assert list(params) == list(own) == names
    assert [tuple(v.shape) for v in own.values()] == [
        tuple(v.shape) for _, v in leaves]
    tops = list(dict.fromkeys(n.split(".")[0] for n in names))
    assert tops == ["dec_blocks", "dec_lnf", "emb", "enc_blocks", "enc_lnf",
                    "head"]
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


def test_full_width_parameter_count(monkeypatch):
    """Full-width whisper-base: the leaf shapes of the reference's tree
    (``jax.eval_shape``), 97,241,088 params, neither materialised."""
    monkeypatch.setattr(torch, "Generator", _CPUGenerator)
    shapes = jax.eval_shape(
        ref_registry.build(ref_registry.get_config(ARCH)).init,
        jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
    model = build(get_config(ARCH), device="meta")
    assert isinstance(model, WhisperLM)
    got = {k: tuple(v.shape) for k, v in model.params().items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 97_241_088


# ---------------------------------------------------------------------------
# the pieces: sinusoid, cross attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [512, 128])
def test_sinusoid_matches_reference(dim):
    pos = np.arange(1500, dtype=np.int32)
    want = np.asarray(ref_whisper.sinusoid(jnp.asarray(pos), dim))
    got = whisper.sinusoid(torch.from_numpy(pos), dim)
    assert got.dtype == torch.float32 and got.shape == (1500, dim)
    half = dim // 2
    freq = np.asarray(jnp.exp(-jnp.log(10000.0) * jnp.arange(half)
                              / max(half - 1, 1)))
    ang = (pos[:, None].astype(np.float32) * freq).astype(np.float32)
    ulp = np.spacing(np.abs(np.concatenate([ang, ang], axis=1)))
    assert (np.abs(got.numpy() - want) <= 4 * ulp + 2.0 ** -21).all()
    # batched positions (..., T) give the same rows
    both = whisper.sinusoid(torch.from_numpy(np.stack([pos[:7], pos[3:10]])),
                            dim)
    assert torch.equal(both[1], got[3:10])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """Queries from 16 tokens, keys and values from 12 frames (S != T),
    with Whisper's biases: the reference's ``attention(..., kv_x=)``."""
    cfg = get_config(ARCH).reduced()
    rp = jax.tree.map(lambda a: a[0], _ref_init()["dec_blocks"]["xattn"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    a = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
             head_dim=cfg.hd, qkv_bias=True, use_rope=False)
    want, _ = ref_cm.attention(RefTape(), "x", "p",
                               jax.tree.map(jnp.asarray, rp),
                               jnp.asarray(x, dtype), ref_cm.AttnCfg(**a),
                               kv_x=jnp.asarray(enc, dtype))
    p = {k: torch.from_numpy(np.asarray(v))
         for k, v in flatten_tree(rp).items()}
    td = getattr(torch, dtype)
    got = cm.cross_attention(Tape(), "x", "p", p, torch.from_numpy(x).to(td),
                             torch.from_numpy(enc).to(td), cm.AttnCfg(**a))
    assert got.dtype == td
    _close(got, np.asarray(want.astype(jnp.float32)),
           2e-6 if dtype == "float32" else 2.0 ** -7)


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
    _hold(grads, rgrads, TOL[dtype][1])
    np.testing.assert_allclose(sq.numpy(), np.asarray(rsq),
                               rtol=TOL[dtype][1])


def test_logits_match_reference():
    """A fresh model loaded with the reference's weights: the logits, and
    the encoder's output on its own."""
    rmodel, rparams, rbatch, model, params, batch = _pair()
    fresh = build(model.cfg, device="cpu")
    fresh.load_state_dict(params)
    want = rmodel.logits(rparams, rbatch["tokens"], rbatch["frontend"],
                         RefTape())
    _close(fresh.logits(batch["tokens"], batch["frontend"]), want, 2e-6)
    _close(fresh.encode(batch["frontend"], Tape()),
           rmodel.encode(rparams, rbatch["frontend"], RefTape()), 2e-6)


@functools.lru_cache(maxsize=None)
def _ref_engines():
    """Every engine's clipped sum and aux on the reference, in one ``jit``
    (one compile for the five); the stream at a tile of 3 below the
    batch of 4."""
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
    assert float(taux["clip_coef"][1]) == 0.0


def test_tape_records_in_reference_order_and_shares_the_encoder():
    """Specs in the reference's insertion order with its kinds, stacks,
    parameter paths and metas; every decoder layer's cross-attention
    ``wk``/``wv`` records the encoder's one output tensor."""
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
    xs = records["dec_blocks/xattn.wk"]["x"] + records[
        "dec_blocks/xattn.wv"]["x"]
    assert all(x.data_ptr() == xs[0].data_ptr() for x in xs)
    assert xs[0].shape == (B, model.cfg.n_audio_frames, model.cfg.d_model)


def test_encoder_frames_take_the_direct_path(monkeypatch):
    """At 192 frames one norm pass calls the kernel's wrapper for every
    encoder dense and the decoder's cross-attention wk/wv, 16 times in all
    on the reduced model, and for nothing else; its norms match the
    reference's (the plain ``ghost_norm_dense`` on the CPU)."""
    rmodel, rparams, rbatch, model, params, batch = _pair(frames=192)
    calls = []
    monkeypatch.setattr(L, "ghost_norm_dense",
                        lambda x, d: calls.append(tuple(x.shape[1:])
                                                  + (d.shape[2],))
                        or gn.ghost_norm_dense(x, d))
    sq, _ = clipping.ghost_norms(model.loss, params, batch)
    d, f = model.cfg.d_model, model.cfg.d_ff
    n = model.cfg.n_layers
    want_calls = ([(192, d, d)] * 4 + [(192, d, f), (192, f, d)]) * n \
        + [(192, d, d)] * 2 * n
    assert sorted(calls) == sorted(want_calls)
    want, _ = jax.jit(lambda p, b: ref_clipping.ghost_norms(
        lambda pp, bb, t: rmodel.loss(pp, bb, t), p, b))(rparams, rbatch)
    np.testing.assert_allclose(sq.numpy(), np.asarray(want), rtol=2e-5)


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
    """2 steps through the streaming engine at a tile of 3 below the
    physical batch of 4, the reference's noise fed in as the update's
    operand; the frontend goes through BatchMemoryManager and the
    session's host-to-device copy with the tokens."""
    engine = "masked_fused_stream"
    ref = RefSession.from_config(
        ARCH, RefDPConfig(engine=engine, clip_norm=1.0, stream_tile=3),
        RefTrainConfig(**TRAIN))
    p0 = jax.tree.map(np.asarray, ref.state.params)
    noise = _reference_noise(ref, TRAIN["steps"])
    ref_out = ref.fit()
    port = PrivacySession.from_config(
        ARCH, DPConfig(engine=engine, clip_norm=1.0, stream_tile=3),
        TrainConfig(**TRAIN), device="cpu",
        params=params_from_numpy(p0, "cpu"))
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
    moved = 0.0
    for k, w in want.items():
        np.testing.assert_allclose(port.state.params[k].numpy(), w, rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
        moved = max(moved, float(np.abs(w - flatten_tree(p0)[k]).max()))
    assert moved > 1e-3
    np.testing.assert_allclose(port.state.opt_state["mom"].numpy(),
                               np.asarray(ref.state.opt_state["mom"]),
                               rtol=0, atol=1e-5 * scale)


def test_checkpoint_round_trip(tmp_path):
    """A 1-step fit checkpointed and restored in a fresh session: params,
    momentum, the step and ε come back bit for bit."""
    d = str(tmp_path / "ck")
    train = TrainConfig(**dict(TRAIN, steps=1))
    dp = DPConfig(engine="masked_bk", clip_norm=1.0)
    s1 = PrivacySession.from_config(ARCH, dp, train, device="cpu")
    s1.fit(ckpt=d)
    s2 = PrivacySession.restore(d, ARCH, dp, train, device="cpu")
    assert s2.state.step == 1
    assert list(s2.state.params) == list(s1.state.params)
    for k, p in s1.state.params.items():
        assert torch.equal(s2.state.params[k], p), k
    assert torch.equal(s2.state.opt_state["mom"], s1.state.opt_state["mom"])
    assert float(s2.privacy_spent()[0]).hex() == \
        float(s1.privacy_spent()[0]).hex()


def test_cli_trains_whisper():
    from repro_torch.launch import train
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--seq-len", "16", "--steps", "1", "--n-data", "16",
                      "--physical", "4", "--q", "0.25", "--engine",
                      "masked_ghost"])
    assert out["history"] and np.isfinite(out["history"][0]["loss"])
