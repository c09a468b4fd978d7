"""The port's DenseLM serving primitives (``init_cache``, ``decode_step``,
``prefill_step`` in ``models/transformer.py``; ``decode_attention`` and the
cache helpers in ``models/common.py``) against the reference's, with the
reference's weights carried over by ``params_from_numpy`` and tokens made
from a numpy seed; then the port against itself.

Tolerances (the two sides use different matmul and reduction stacks, and
``cos``/``sin``/``exp``/``silu`` differ by ULPs):
* f32 (reduced configs, f32 cache): logits within 2e-5 of the largest
  logit, cache entries within 2e-5 of the largest entry (measured at most
  1.4e-6 and 1.0e-6 over decode and prefill).
* bf16 activations and a bf16 cache: layer 0's cache within 2^-7 of its
  largest entry (one bf16 step; measured 4.4e-6), the later layers' within
  2e-2 (their inputs carry the earlier layers' bf16 roundings; measured
  9.8e-3), logits within 2e-2 of the largest logit (DenseLM's bf16 loss
  bound; measured 1.4e-2): a value rounded on one side of a bf16 tie can
  round the other way on the other side.
* Within the port: the unconsumed tail and a scalar against a vector
  position are bitwise; decode against the full-sequence ``logits()``, a
  row in a batch against the same row alone and a chunk against per-token
  decode within the bounds above (other matmul shapes: PyTorch's CPU GEMM
  bits depend on the row count).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen3_1_7b import SLIDING as REF_SWA
from repro.models.registry import build as ref_build
from repro.models.registry import get_config as ref_get_config
from repro_torch.configs import get_config
from repro_torch.configs.qwen3_1_7b import SLIDING
from repro_torch.models import build
from repro_torch.models import common as cm
from repro_torch.utils.params import params_from_numpy

ARCHS = ["qwen2-0.5b", "qwen3-1.7b", "llama3.2-3b", "qwen3-1.7b-swa"]
B, STEPS = 3, 12
LOGIT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
DEEP_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(name, dtype, **over):
    if name == "qwen3-1.7b-swa":
        rcfg, cfg = REF_SWA.reduced(dtype=dtype), SLIDING.reduced(dtype=dtype)
    else:
        rcfg = ref_get_config(name).reduced(dtype=dtype)
        cfg = get_config(name).reduced(dtype=dtype)
    return dataclasses.replace(rcfg, **over), dataclasses.replace(cfg, **over)


@functools.lru_cache(maxsize=None)
def _pair(name, dtype, window=None):
    """(reference model, its params, jitted decode and prefill, the port's
    model with the same weights loaded, its params dict)."""
    over = {} if window is None else {"sliding_window": window}
    rcfg, cfg = _configs(name, dtype, **over)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    model.load_state_dict(params)
    return (rmodel, rparams, jax.jit(rmodel.decode_step),
            jax.jit(rmodel.prefill_step), model, params)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _rel_err(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _check_cache(cache, rcache, dtype):
    """Each layer's K and V within the dtype's bound of its largest entry:
    layer 0 (the same inputs on both sides) at CACHE_TOL, the later layers
    (their inputs carry the earlier layers' bf16 roundings) at DEEP_TOL."""
    for n in ("k", "v"):
        want = rcache["blocks"][n]
        got = cache["blocks"][n]
        assert tuple(got.shape) == want.shape
        for layer in range(want.shape[0]):
            err = _rel_err(got[layer], want[layer])
            tol = CACHE_TOL[dtype] if layer == 0 else DEEP_TOL[dtype]
            assert err <= tol, (n, layer, err)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                              else torch.int32),
                       b.view(torch.int16 if b.dtype == torch.bfloat16
                              else torch.int32))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_init_cache_matches_reference(name, dtype):
    rmodel, rparams, _, _, model, params = _pair(name, "float32")
    jdt, tdt = DTYPES[dtype]
    want = rmodel.init_cache(rparams, B, 24, dtype=jdt)
    got = model.init_cache(params, B, 24, dtype=tdt)
    assert set(got) == {"blocks"} and set(got["blocks"]) == {"k", "v"}
    for n in ("k", "v"):
        w, g = want["blocks"][n], got["blocks"][n]
        assert tuple(g.shape) == w.shape and g.dtype == tdt
        assert not g.any()
    # the default dtype is bf16, as in the reference
    assert model.init_cache(params, 1, 8)["blocks"]["k"].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("pos_kind", ["scalar", "vector"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_reference(name, dtype, pos_kind):
    """12 steps from an empty cache; the vector case starts the rows at
    depths 0, 2 and 5 (the sliding window's ring of 16 wraps at 16)."""
    rmodel, rparams, rdecode, _, model, params = _pair(name, dtype)
    jdt, tdt = DTYPES[dtype]
    S = 20
    rcache = rmodel.init_cache(rparams, B, S, dtype=jdt)
    cache = model.init_cache(params, B, S, dtype=tdt)
    toks = _tokens(model.cfg, (B, STEPS), 1)
    start = np.array([0, 2, 5], np.int32)
    for t in range(STEPS):
        pos = t if pos_kind == "scalar" else start + t
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(pos, jnp.int32))
        lg, cache = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, t:t + 1]),
                                      torch.as_tensor(pos))
        assert lg.shape == (B, model.cfg.vocab)
        err = _rel_err(lg, rl)
        assert err <= LOGIT_TOL[dtype], (t, err)
    _check_cache(cache, rcache, dtype)


PREFILL_CASES = [(n, c) for n in ARCHS[:3] for c in (1, 3, 8)] + [
    ("qwen3-1.7b-swa", 1)]


@pytest.mark.parametrize("name,C", PREFILL_CASES)
def test_prefill_step_matches_reference(name, C):
    """Four chunks of C tokens at per-row offsets (rows start at 0, 3 and
    1), each row consuming n_tok in 0..C of each chunk (0 and C both
    occur in every chunk); logits and caches after every chunk."""
    rmodel, rparams, _, rprefill, model, params = _pair(name, "float32")
    S = 40
    rcache = rmodel.init_cache(rparams, B, S, dtype=jnp.float32)
    cache = model.init_cache(params, B, S, dtype=torch.float32)
    rng = np.random.default_rng(C)
    pos = np.array([0, 3, 1], np.int32)
    for i in range(4):
        n_tok = rng.integers(0, C + 1, B).astype(np.int32)
        n_tok[i % B], n_tok[(i + 1) % B] = C, 0
        toks = _tokens(model.cfg, (B, C), 10 + i)
        rl, rcache = rprefill(rparams, rcache, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(n_tok))
        lg, cache = model.prefill_step(params, cache, torch.from_numpy(toks),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(n_tok))
        err = _rel_err(lg, rl)
        assert err <= LOGIT_TOL["float32"], (i, err)
        _check_cache(cache, rcache, "float32")
        pos = pos + n_tok


def test_ring_wraparound_matches_reference():
    """Decode 12 tokens past a sliding window of 4: the ring rows are
    overwritten as the reference overwrites them, and the logits equal the
    port's own full-sequence forward under the window's mask."""
    rmodel, rparams, rdecode, _, model, params = _pair("qwen3-1.7b",
                                                       "float32", window=4)
    rcache = rmodel.init_cache(rparams, B, STEPS, dtype=jnp.float32)
    cache = model.init_cache(params, B, STEPS, dtype=torch.float32)
    assert cache["blocks"]["k"].shape[2] == 4
    toks = _tokens(model.cfg, (B, STEPS), 2)
    full = model.logits(torch.from_numpy(toks)).detach()
    for t in range(STEPS):
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        lg, cache = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, t:t + 1]), t)
        assert _rel_err(lg, rl) <= LOGIT_TOL["float32"], t
        assert _rel_err(lg, full[:, t].numpy()) <= LOGIT_TOL["float32"], t
    _check_cache(cache, rcache, "float32")


@pytest.mark.parametrize("S,T,pos,masked", [
    (8, 3, [0, 5, 7, 9], False),     # a chunk running past the cache's end
    (8, 3, [0, 5, 7, 9], True),      # ... with ragged n_tok, 0 and 3 among them
    (4, 7, [0, 1, 3, 6], True),      # a chunk longer than the cache
    (4, 1, [2, 5, 6, 11], False),    # ring rows (pos mod S) of one token
])
def test_scatter_rows_matches_reference(S, T, pos, masked):
    """Cache writes bitwise against the reference's scatter: writes past S
    and masked tail writes leave their rows' old values."""
    from repro.models.common import scatter_rows as ref_scatter_rows
    rng = np.random.default_rng(S * 100 + T)
    nb = len(pos)
    buf = rng.standard_normal((nb, S, 2, 3)).astype(np.float32)
    vals = rng.standard_normal((nb, T, 2, 3)).astype(np.float32)
    slot = np.asarray(pos, np.int32)[:, None] + np.arange(T, dtype=np.int32)
    if T == 1:
        slot = slot % S
    valid = (np.arange(T)[None, :] < np.array([0, 1, T, T - 1])[:, None]
             if masked else None)
    want = ref_scatter_rows(jnp.asarray(buf), jnp.asarray(slot),
                            jnp.asarray(vals),
                            None if valid is None else jnp.asarray(valid))
    got = cm.scatter_rows(torch.from_numpy(buf.copy()), torch.from_numpy(slot),
                          torch.from_numpy(vals),
                          None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunk_on_a_window_raises_as_the_reference():
    rmodel, rparams, _, _, model, params = _pair("qwen3-1.7b-swa", "float32")
    toks = _tokens(model.cfg, (B, 2), 3)
    pos, n_tok = np.zeros(B, np.int32), np.full(B, 2, np.int32)
    with pytest.raises(ValueError, match="sliding-window"):
        rmodel.prefill_step(rparams, rmodel.init_cache(rparams, B, 8),
                            jnp.asarray(toks), jnp.asarray(pos),
                            jnp.asarray(n_tok))
    with pytest.raises(ValueError, match="sliding-window"):
        model.prefill_step(params, model.init_cache(params, B, 8),
                           torch.from_numpy(toks), torch.from_numpy(pos),
                           torch.from_numpy(n_tok))
    with pytest.raises(ValueError, match="scalar or shape"):
        cm.decode_positions(torch.zeros(B + 1, dtype=torch.int32), B)


def test_greedy_tokens_match_reference():
    """16 greedy f32 steps after a 4-token prompt, each side feeding back
    its own argmax.  Every step's top-2 margin in the reference's logits
    is asserted above twice the logit tolerance, so equal tokens are what
    the tolerance implies and a near tie cannot flake."""
    rmodel, rparams, rdecode, _, model, params = _pair("qwen2-0.5b",
                                                       "float32")
    n_prompt, n_new = 4, 16
    S = n_prompt + n_new
    rcache = rmodel.init_cache(rparams, B, S, dtype=jnp.float32)
    cache = model.init_cache(params, B, S, dtype=torch.float32)
    prompt = _tokens(model.cfg, (B, n_prompt), 4)
    rtok, tok = jnp.asarray(prompt[:, :1]), torch.from_numpy(prompt[:, :1])
    for t in range(S - 1):
        rl, rcache = rdecode(rparams, rcache, rtok, jnp.int32(t))
        lg, cache = model.decode_step(params, cache, tok, t)
        if t + 1 < n_prompt:
            rtok = jnp.asarray(prompt[:, t + 1:t + 2])
            tok = torch.from_numpy(prompt[:, t + 1:t + 2])
            continue
        want = np.asarray(rl)
        top2 = np.sort(want, axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin > 2 * LOGIT_TOL["float32"] * np.abs(want).max(), t
        rtok = jnp.argmax(rl, axis=-1).astype(jnp.int32)[:, None]
        tok = lg.argmax(dim=-1).to(torch.int32)[:, None]
        assert tok.numpy().tolist() == np.asarray(rtok).tolist(), t


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

def test_unconsumed_tail_leaves_the_cache_bitwise():
    """Rows taking 0, 2 and 5 of a chunk of 5: every cache row outside the
    consumed positions keeps its bits (here a cache already filled by an
    earlier chunk of 5 everywhere)."""
    _, _, _, _, model, params = _pair("qwen2-0.5b", "bfloat16")
    C, S = 5, 16
    cache = model.init_cache(params, B, S)
    full = np.full(B, C, np.int32)
    model.prefill_step(params, cache, torch.from_numpy(
        _tokens(model.cfg, (B, C), 5)), 0, torch.from_numpy(full))
    before = {n: c.clone() for n, c in cache["blocks"].items()}
    n_tok = np.array([0, 2, 5], np.int32)
    _, cache = model.prefill_step(params, cache, torch.from_numpy(
        _tokens(model.cfg, (B, C), 6)), torch.from_numpy(full),
        torch.from_numpy(n_tok))
    for n, c in cache["blocks"].items():
        for r in range(B):
            written = slice(C, C + int(n_tok[r]))
            kept = torch.ones(S, dtype=torch.bool)
            kept[written] = False
            assert _same_bits(c[:, r, kept], before[n][:, r, kept]), (n, r)
            if n_tok[r]:
                assert not torch.equal(c[:, r, written],
                                       before[n][:, r, written]), (n, r)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-1.7b-swa"])
def test_prefill_by_decode_matches_logits(name):
    """Per-token decode of a sequence equals the port's full-sequence
    ``logits()`` (the window's sequence of 20 is past its ring of 16), and
    a scalar position equals a vector of equal positions bitwise."""
    _, _, _, _, model, params = _pair(name, "float32")
    T = 20
    toks = torch.from_numpy(_tokens(model.cfg, (B, T), 7))
    full = model.logits(toks).detach()
    cache = model.init_cache(params, B, T, dtype=torch.float32)
    vcache = model.init_cache(params, B, T, dtype=torch.float32)
    for t in range(T):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        vl, vcache = model.decode_step(params, vcache, toks[:, t:t + 1],
                                       torch.full((B,), t, dtype=torch.int32))
        assert _rel_err(lg, full[:, t].numpy()) <= LOGIT_TOL["float32"], t
        assert _same_bits(lg, vl), t
    for n in ("k", "v"):
        assert _same_bits(cache["blocks"][n], vcache["blocks"][n])


def test_a_row_at_its_own_depth_matches_it_alone():
    """Three rows whose prompts of 0, 4 and 9 tokens are prefilled in one
    chunk, then decoded 8 steps together at their own depths: each row's
    logits and cache equal the same row run alone (B = 1)."""
    _, _, _, _, model, params = _pair("qwen3-1.7b", "float32")
    S, steps, C = 20, 8, 9
    n_prompt = np.array([0, 4, 9], np.int32)
    prompt = torch.from_numpy(_tokens(model.cfg, (B, C), 8))
    toks = torch.from_numpy(_tokens(model.cfg, (B, steps), 18))

    def run(rows):
        cache = model.init_cache(params, len(rows), S, dtype=torch.float32)
        n = torch.from_numpy(n_prompt[rows])
        _, cache = model.prefill_step(params, cache, prompt[rows], 0, n)
        out = []
        for t in range(steps):
            lg, cache = model.decode_step(params, cache,
                                          toks[rows, t:t + 1], n + t)
            out.append(lg)
        return torch.stack(out, 1), cache

    together, cache = run(list(range(B)))
    for i in range(B):
        alone, alone_cache = run([i])
        err = _rel_err(together[i], alone[0].numpy())
        assert err <= LOGIT_TOL["float32"], (i, err)
        for n in ("k", "v"):
            err = _rel_err(cache["blocks"][n][:, i],
                           alone_cache["blocks"][n][:, 0].numpy())
            assert err <= CACHE_TOL["float32"], (i, n, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2-0.5b", "llama3.2-3b"])
def test_chunked_prefill_matches_per_token_decode(name, dtype):
    """A chunk of 8 (rows taking 8, 5 and 3 tokens at offsets 0, 2 and 1)
    against the same tokens decoded one at a time, each row alone: the
    caches within CACHE_TOL of their largest entry and each row's logits at
    its last consumed token within LOGIT_TOL.  The reference states this
    is bitwise for GQA on XLA:CPU; the port is not, since PyTorch's CPU
    GEMM rounds a product of 8 rows otherwise than one of 1 (measured f32
    up to 9.7e-7 of the largest logit and 9.4e-7 of the largest cache
    entry, already at layer 0's projections; bf16 bitwise on qwen2, and on
    llama3.2 1.25e-3 of the largest logit and 3.0e-4 of the largest cache
    entry)."""
    _, _, _, _, model, params = _pair(name, dtype)
    tdt = DTYPES[dtype][1]
    C, S = 8, 16
    toks = torch.from_numpy(_tokens(model.cfg, (B, C), 9))
    pos = torch.tensor([0, 2, 1], dtype=torch.int32)
    n_tok = torch.tensor([8, 5, 3], dtype=torch.int32)
    chunk = model.init_cache(params, B, S, dtype=tdt)
    lg, chunk = model.prefill_step(params, chunk, toks, pos, n_tok)
    for i in range(B):
        cache = model.init_cache(params, 1, S, dtype=tdt)
        for j in range(int(n_tok[i])):
            dl, cache = model.decode_step(params, cache,
                                          toks[i:i + 1, j:j + 1],
                                          pos[i:i + 1] + j)
        for n in ("k", "v"):
            err = _rel_err(chunk["blocks"][n][:, i],
                           cache["blocks"][n][:, 0].float().numpy())
            assert err <= CACHE_TOL[dtype], (i, n, err)
        err = _rel_err(lg[i], dl[0].float().numpy())
        assert err <= LOGIT_TOL[dtype], (i, err)
