"""Serving on the recurrent-state families: the port's Mamba2 and Zamba2
decode caches (``init_cache``, ``decode_step``, chunked ``prefill_step`` in
``models/mamba2.py`` and ``models/zamba2.py``) and ``ServeEngine``,
``session.generate`` and the serving CLI over them, against the
reference's on the same weights, then the port against itself: the twins
of ``tests/test_serve.py``'s SSM tests.

Models: reduced mamba2-1.3b (2 layers), reduced zamba2-1.2b (2 supers of
one mamba layer) and the narrow hybrid of ``tests/test_torch_ssm.py``
(``attn_every`` 2, 5 layers: 2 supers of 2 and a tail of 1), in f32; the
reference's weights carried over by ``params_from_numpy``, tokens and
prompts from a numpy seed.

Tolerances:
* cache layout, probed axes, schedules (paths, positions, ``n_tok``,
  iterations), prompts: exact.
* ``decode_step`` and ``prefill_step`` against the reference's (C 1, 3, 8;
  ragged ``n_tok`` with 0 and C): logits within 2e-5 of the largest logit
  and every cache leaf within 2e-5 of its largest entry, DenseLM's f32
  bounds (``tests/test_torch_decode.py``; measured at most 3.1e-6).  A row
  that consumes nothing keeps its state and conv bit for bit.
* prefill-by-decode against the port's own ``logits()``: the reference's
  bounds for it (rtol 2e-3, atol 5e-3 on mamba2,
  ``tests/test_models_smoke.py``; 3e-3, 5e-3 on zamba2,
  ``tests/test_decode_equivalence.py``).
* tokens: equal, with every sampled position's margin asserted in the
  logits the tokens come from (``tests/test_torch_serve.py``'s
  ``_assert_margins``: the top-2 gap above twice the f32 logit bound).
  The reference's chunked SSM prefill is bitwise to per-token decode; the
  port's is not (a GEMM of C rows rounds unlike one of 1), so the twin of
  ``test_chunked_prefill_matches_solo_ssm`` holds the tokens with the
  margins asserted.  Slot reuse, the pool's reset and a request alone at
  the same width are bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPConfig as RefDPConfig
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.core.tape import Tape as RefTape
from repro.models.registry import build as ref_build
from repro.models.registry import get_config as ref_get_config
from repro.serve import Request as RefRequest
from repro.serve import SamplingParams as RefSamplingParams
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import cache_pool as ref_cache_pool
from repro_torch.configs import get_config
from repro_torch.core import DPConfig
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.launch import serve
from repro_torch.models import build
from repro_torch.serve import CachePool, Request, SamplingParams, ServeEngine
from repro_torch.serve import cache_pool as port_cache_pool
from repro_torch.utils.params import flatten_tree, params_from_numpy
from test_torch_serve import (_assert_margins, _by_rid, _capture, _drive,
                              _request)

# name -> (arch, overrides of reduced())
MODELS = {"mamba2": ("mamba2-1.3b", {}),
          "zamba2": ("zamba2-1.2b", {}),
          "hybrid5": ("zamba2-1.2b", dict(attn_every=2, n_layers=5))}
ARCHS = {"mamba2": "mamba2-1.3b", "zamba2": "zamba2-1.2b"}
LOGIT_TOL = 2e-5
CACHE_TOL = 2e-5
# prefill-by-decode against logits(): the reference's own (rtol, atol)
FULL_TOL = {"mamba2": (2e-3, 5e-3), "zamba2": (3e-3, 5e-3),
            "hybrid5": (3e-3, 5e-3)}
B = 3
MAX_LEN = 32
# the engine mixes: one token an iteration, and chunks of 3 under a budget
# of 4 with a mid-flight admission and a sampled request
MIXES = {"one_token": dict(width=4, early=list(zip([3, 7, 2, 5, 4, 6],
                                                   [9, 3, 12, 5, 7, 4])),
                           seed=0),
         "chunk3": dict(width=3, early=[(9, 6), (4, 8)], seed=7, steps=3,
                        late=[(11, 5), (6, 7, (0.9, 4, 13))], late_seed=8,
                        chunk=3, budget=4)}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: many small ops, which stall on thread barriers
    when several test workers share the machine's cores (every side of a
    comparison runs in this process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    arch, over = MODELS[name]
    return (dataclasses.replace(ref_get_config(arch).reduced(dtype="float32"),
                                **over),
            dataclasses.replace(get_config(arch).reduced(dtype="float32"),
                                **over))


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference model, its params, jitted decode and prefill, the port's
    model with the same weights, its params)."""
    rcfg, cfg = _cfgs(name)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    model.load_state_dict(params)
    return (rmodel, rparams, jax.jit(rmodel.decode_step),
            jax.jit(rmodel.prefill_step), model, params)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab,
                                                shape).astype(np.int32)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _check_cache(cache, rcache):
    want = flatten_tree(rcache)
    got = flatten_tree(cache)
    assert list(got) == list(want)
    for n in want:
        assert tuple(got[n].shape) == want[n].shape, n
        assert _rel_err(got[n], want[n]) <= CACHE_TOL, n


def _clone(cache):
    return {n: c.clone() for n, c in flatten_tree(cache).items()}


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# the model steps against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_init_cache_matches_reference(name):
    """Leaf names, shapes and dtypes in ``jax.tree.leaves`` order (the
    state f32 whatever the dtype), the default dtype, and the pool's
    probed batch and position axes equal the reference's."""
    rcfg, cfg = _cfgs(name)
    rmodel = ref_build(rcfg)
    rparams = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    model = build(cfg, device="cpu")
    params = model.params()
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = flatten_tree(jax.eval_shape(
            lambda p: rmodel.init_cache(p, B, 24, dtype=jdt), rparams))
        got = flatten_tree(model.init_cache(params, B, 24, dtype=tdt))
        assert list(got) == list(want)
        for n, w in want.items():
            assert tuple(got[n].shape) == w.shape, n
            assert str(got[n].dtype).split(".")[-1] == str(w.dtype), n
            assert not got[n].any(), n
    default = flatten_tree(model.init_cache(params, 1, 8))
    want_default = flatten_tree(jax.eval_shape(
        lambda p: rmodel.init_cache(p, 1, 8), rparams))
    assert [str(c.dtype).split(".")[-1] for c in default.values()] == \
        [str(w.dtype) for w in want_default.values()]
    axes = {}
    for fn in ("detect_batch_axes", "detect_pos_axes"):
        want = getattr(ref_cache_pool, fn)(rmodel, rparams, 24, jnp.float32,
                                           {})
        axes[fn] = getattr(port_cache_pool, fn)(model, params, 24,
                                                torch.float32)
        assert axes[fn] == want, fn
    # the state and conv have no position axis; zamba2's nested supers.*
    # leaves carry the batch on axis 2
    for n, bax, pax in zip(got, axes["detect_batch_axes"],
                           axes["detect_pos_axes"]):
        assert (pax is None) == (not n.startswith("attn.")), n
        assert bax == (2 if n.startswith("supers.") else 1), n


@pytest.mark.parametrize("name", ["mamba2", "hybrid5"])
def test_decode_step_matches_reference(name):
    """8 steps from an empty cache, the rows at depths 0, 2 and 5 (the
    hybrid holds Zamba2LM's supers and tail; reduced zamba2 is held through
    its chunk steps below and its engine's decode steps)."""
    rmodel, rparams, rdecode, _, model, params = _pair(name)
    rcache = rmodel.init_cache(rparams, B, 20, dtype=jnp.float32)
    cache = model.init_cache(params, B, 20, dtype=torch.float32)
    toks = _tokens(model.cfg.vocab, (B, 8), 1)
    start = np.array([0, 2, 5], np.int32)
    for t in range(8):
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(start + t))
        lg, cache = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, t:t + 1]),
                                      torch.from_numpy(start + t))
        assert lg.shape == (B, model.cfg.vocab)
        assert _rel_err(lg, rl) <= LOGIT_TOL, t
    _check_cache(cache, rcache)


@pytest.mark.parametrize("name,C", [("mamba2", 1), ("mamba2", 3),
                                    ("mamba2", 8), ("zamba2", 3),
                                    ("hybrid5", 1), ("hybrid5", 3),
                                    ("hybrid5", 8)])
def test_prefill_step_matches_reference(name, C):
    """Four chunks of C tokens at per-row offsets, each row consuming 0..C
    of each chunk (0 and C in every chunk): logits and every cache leaf
    after every chunk; a row that consumes nothing keeps every leaf's bits
    (its state and conv, and its K/V)."""
    rmodel, rparams, _, rprefill, model, params = _pair(name)
    rcache = rmodel.init_cache(rparams, B, 40, dtype=jnp.float32)
    cache = model.init_cache(params, B, 40, dtype=torch.float32)
    rng = np.random.default_rng(C)
    pos = np.array([0, 3, 1], np.int32)
    for i in range(4):
        n_tok = rng.integers(0, C + 1, B).astype(np.int32)
        n_tok[i % B], n_tok[(i + 1) % B] = C, 0
        toks = _tokens(model.cfg.vocab, (B, C), 10 + i)
        rl, rcache = rprefill(rparams, rcache, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(n_tok))
        before = _clone(cache)
        lg, cache = model.prefill_step(params, cache, torch.from_numpy(toks),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(n_tok))
        assert _rel_err(lg, rl) <= LOGIT_TOL, i
        _check_cache(cache, rcache)
        stalled = (i + 1) % B
        axes = port_cache_pool.detect_batch_axes(model, params, 40,
                                                 torch.float32)
        for (n, c), ax in zip(flatten_tree(cache).items(), axes):
            assert _same_bits(c.select(ax, stalled),
                              before[n].select(ax, stalled)), (i, n)
        pos = pos + n_tok


@pytest.mark.parametrize("name", list(MODELS))
def test_chunked_prefill_matches_per_token_decode(name):
    """Within the port: 8 tokens in chunks of 3 (the last of 2) against
    the same tokens decoded one at a time, logits and every cache leaf
    within the f32 bounds (not bitwise: a GEMM of C rows rounds unlike one
    of 1; measured at most 2.4e-6)."""
    _, _, _, _, model, params = _pair(name)
    toks = torch.from_numpy(_tokens(model.cfg.vocab, (B, 8), 5))
    one = model.init_cache(params, B, 16, dtype=torch.float32)
    for t in range(8):
        want, one = model.decode_step(params, one, toks[:, t:t + 1], t)
    cache = model.init_cache(params, B, 16, dtype=torch.float32)
    for pos in range(0, 8, 3):
        n = min(3, 8 - pos)
        got, cache = model.prefill_step(params, cache, toks[:, pos:pos + n],
                                        pos, torch.full((B,), n))
    assert _rel_err(got, want) <= LOGIT_TOL
    for n, c in flatten_tree(cache).items():
        assert _rel_err(c, flatten_tree(one)[n]) <= CACHE_TOL, n


@pytest.mark.parametrize("name", ["mamba2", "hybrid5"])
def test_prefill_by_decode_matches_logits(name):
    """Greedy prefill-by-decode reproduces the port's full-sequence logits
    at every position (``tests/test_models_smoke.py:91``,
    ``tests/test_decode_equivalence.py:61``), and chunks of 4 give the
    same rows within the same bounds."""
    _, _, _, _, model, params = _pair(name)
    toks = torch.from_numpy(_tokens(model.cfg.vocab, (2, 8), 1))
    with torch.no_grad():
        full = model.logits(toks)
    rtol, atol = FULL_TOL[name]
    cache = model.init_cache(params, 2, 8, dtype=torch.float32)
    for t in range(8):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=rtol, atol=atol)
    cache = model.init_cache(params, 2, 8, dtype=torch.float32)
    n = torch.full((2,), 4, dtype=torch.int32)
    for i in (0, 4):
        lg, cache = model.prefill_step(params, cache, toks[:, i:i + 4], i, n)
        np.testing.assert_allclose(lg.numpy(), full[:, i + 3].numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["mamba2", "hybrid5"])
def test_bf16_decode_gap_is_the_references_own(name):
    """In bf16 prefill-by-decode rounds apart from ``logits()`` (the decode
    conv sums in f32, the training conv in bf16), in the reference as in
    the port: on the same weights the port's gap is within twice the
    reference's own, and the reference's is not 0.  This is why the card
    holds the full-depth SSMs' decode path against ``logits()`` in f32 and
    only prints its bf16 gap."""
    rcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs(name))
    rmodel, model = ref_build(rcfg), build(cfg, device="cpu")
    rparams = _pair(name)[1]
    model.load_state_dict(_pair(name)[5])
    params = model.params()
    toks = _tokens(cfg.vocab, (2, 8), 1)
    rfull = np.asarray(rmodel.logits(rparams, jnp.asarray(toks), RefTape()),
                       np.float32)
    rcache = rmodel.init_cache(rparams, 2, 8, dtype=jnp.bfloat16)
    cache = model.init_cache(params, 2, 8, dtype=torch.bfloat16)
    with torch.no_grad():
        full = model.logits(torch.from_numpy(toks)).float()
    rdecode = jax.jit(rmodel.decode_step)
    gaps = [0.0, 0.0]
    for t in range(8):
        rl, rcache = rdecode(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        lg, cache = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, t:t + 1]), t)
        gaps[0] = max(gaps[0], _rel_err(torch.from_numpy(np.asarray(
            rl, np.float32)), rfull[:, t]))
        gaps[1] = max(gaps[1], _rel_err(lg.float(), full[:, t]))
    ref_gap, port_gap = gaps
    assert ref_gap > 2.0 ** -9, gaps
    assert port_gap <= 2 * ref_gap, gaps


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_sessions():
    return {k: RefSession.from_config(arch, RefDPConfig(engine="nonprivate"),
                                      RefTrainConfig(seed=0, smoke=True))
            for k, arch in ARCHS.items()}


@pytest.fixture(scope="module")
def sessions(ref_sessions):
    out = {}
    for k, arch in ARCHS.items():
        params = params_from_numpy(jax.tree.map(
            np.asarray, ref_sessions[k].state.params), "cpu")
        out[k] = PrivacySession.from_config(
            arch, DPConfig(engine="nonprivate"),
            TrainConfig(seed=0, smoke=True), device="cpu", params=params)
    return out


def _engines(made, session, engine_cls):
    def get(width, chunk=1, budget=None):
        if (width, chunk, budget) not in made:
            made[width, chunk, budget] = engine_cls.from_session(
                session, max_slots=width, max_len=MAX_LEN,
                prefill_chunk=chunk, token_budget=budget,
                prefix_sharing=False)
        return made[width, chunk, budget]
    return get


@pytest.fixture(scope="module")
def engines(sessions, ref_sessions):
    """{family: (the reference's engine getter, the port's)}, each engine
    built once per (width, chunk, budget)."""
    return {k: (_engines({}, ref_sessions[k], RefServeEngine),
                _engines({}, sessions[k], ServeEngine)) for k in ARCHS}


def _key(mix):
    return mix["width"], mix.get("chunk", 1), mix.get("budget")


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("family", list(ARCHS))
def test_mix_matches_reference(sessions, engines, family, mix):
    """The same tokens per rid (margins asserted), finish reasons,
    iterations, occupancy, and in every iteration the same path,
    positions and consume counts."""
    m = MIXES[mix]
    vocab = sessions[family].model_cfg.vocab
    ref_get, get = engines[family]
    ref = ref_get(*_key(m))
    with _capture(ref, np.asarray) as log:
        want = _drive(ref, m, vocab, RefRequest, RefSamplingParams)
    eng = get(*_key(m))
    assert not eng.prefix_sharing and not eng.pool.supports_prefix_sharing
    with _capture(eng, lambda t: t.numpy()) as got_log:
        got = _drive(eng, m, vocab)
    assert _assert_margins(log) == sum(map(len, _by_rid(want).values()))
    assert _by_rid(got) == _by_rid(want)
    assert _by_rid(got, "finish_reason") == _by_rid(want, "finish_reason")
    assert (got["iterations"], got["occupancy"]) == (want["iterations"],
                                                     want["occupancy"])
    assert len(got_log) == len(log)
    for i, (g, w) in enumerate(zip(got_log, log)):
        assert g["path"] == w["path"], i
        np.testing.assert_array_equal(g["pos"], w["pos"], err_msg=str(i))
        np.testing.assert_array_equal(g["n_tok"], w["n_tok"],
                                      err_msg=str(i))
        assert g["decoding"] == w["decoding"], i
    paths = {w["path"] for w in log}
    assert paths == ({"decode"} if m.get("chunk", 1) == 1
                     else {"decode", "chunk"})
    if mix == "chunk3":
        # the budget stalled a prefilling slot in some iteration
        assert any((w["n_tok"] == 0).any() and len(w["decoding"]) < 3
                   for w in log if w["path"] == "chunk")
    assert got["prefix_hits"] == 0


# ---------------------------------------------------------------------------
# the twins of tests/test_serve.py's SSM tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(ARCHS))
def test_slot_reuse_does_not_leak_ssm_state(sessions, engines, family):
    """Identical prompts before and after other traffic through the same
    slots give the same tokens and the same first-token logits, bitwise
    (``tests/test_serve.py:97``): the reset clears the state and conv."""
    session = sessions[family]
    vocab = session.model_cfg.vocab
    engine = engines[family][1](2)
    rng = np.random.RandomState(3)
    probe = Request(prompt=rng.randint(0, vocab, size=4).tolist(),
                    max_new_tokens=6)
    with _capture(engine, lambda t: t.numpy()) as first_log:
        first = engine.run([probe])["results"][0]["generated"]
    rng = np.random.RandomState(4)
    engine.run([Request(prompt=rng.randint(0, vocab, size=n).tolist(),
                        max_new_tokens=5) for n in (6, 3, 5)])
    with _capture(engine, lambda t: t.numpy()) as again_log:
        again = engine.run([probe])["results"][0]["generated"]
    assert first == again, "slot reuse leaked state across requests"
    assert len(first_log) == len(again_log)
    for a, b in zip(first_log, again_log):
        np.testing.assert_array_equal(a["n_tok"], b["n_tok"])
        live = a["n_tok"] > 0          # the free slot's row is garbage
        np.testing.assert_array_equal(a["logits"][live], b["logits"][live])


@pytest.mark.parametrize("family", list(ARCHS))
def test_chunked_prefill_matches_solo_ssm(sessions, engines, family):
    """Chunked prefill (C 3) against prefill-by-decode at the same width
    and against one slot (``tests/test_serve.py:202``): the same tokens,
    every position's margin asserted in the one-token run's logits."""
    session = sessions[family]
    vocab = session.model_cfg.vocab
    get = engines[family][1]
    rng = np.random.RandomState(10)
    specs = [(i, rng.randint(0, vocab, size=n).tolist(), nt, None)
             for i, (n, nt) in enumerate(zip([8, 3, 10], [5, 7, 4]))]

    def reqs():
        return [_request(s, Request, SamplingParams) for s in specs]

    with _capture(get(2), lambda t: t.numpy()) as log:
        gp = _by_rid(get(2).run(reqs()))
    assert _assert_margins(log) == sum(nt for _, _, nt, _ in specs)
    gc = _by_rid(get(2, 3).run(reqs()))
    assert gc == gp, "chunked SSM prefill diverged from prefill-by-decode"
    for r in reqs():
        assert get(1).run([r])["results"][0]["generated"] == gc[r.rid]


@pytest.mark.parametrize("family", list(ARCHS))
def test_prefix_sharing_refused_on_accumulating_caches(sessions, engines,
                                                       family):
    """Asked for prefix sharing, a pool with accumulating leaves refuses
    (``tests/test_serve.py:305``): no index, 0 hits, and each request's
    tokens equal its run alone (margins asserted)."""
    session = sessions[family]
    vocab = session.model_cfg.vocab
    engine = ServeEngine.from_session(session, max_slots=2, max_len=MAX_LEN,
                                      prefix_sharing=True)
    assert not engine.prefix_sharing
    assert not engine.pool.supports_prefix_sharing
    assert engine.pool.prefix_index is None
    rng = np.random.RandomState(17)
    base = rng.randint(0, vocab, size=8).tolist()
    r1 = Request(prompt=base, max_new_tokens=10, rid=0)
    r2 = Request(prompt=base[:6] + np.random.RandomState(18).randint(
        0, vocab, size=2).tolist(), max_new_tokens=5, rid=1)
    with _capture(engine, lambda t: t.numpy()) as log:
        engine.submit(r1)
        for _ in range(9):
            engine.step()
        engine.submit(r2)
        out = engine.run()
    _assert_margins(log)
    assert out["prefix_hits"] == 0 and out["prefix_hit_rate"] == 0
    solo = engines[family][1](1)
    gen = _by_rid(out)
    for r in (r1, r2):
        assert solo.run([Request(prompt=r.prompt,
                                 max_new_tokens=r.max_new_tokens)]
                        )["results"][0]["generated"] == gen[r.rid]


@pytest.mark.parametrize("family", list(ARCHS))
def test_cache_pool_reset_restores_state_leaves(sessions, family):
    """The state and conv leaves (no max_len axis) need a reset and are
    restored to the template at the reset slot, bitwise; the other slots
    and zamba2's position-indexed K/V keep their bits
    (``tests/test_serve.py:419``)."""
    session = sessions[family]
    pool = CachePool(session.model, session.state.params, 3, 16)
    names = list(flatten_tree(pool.cache))
    assert pool._needs_reset == [not n.startswith("attn.") for n in names]
    assert any(pool._needs_reset)
    pool.insert()
    pool.insert()
    template = dict(zip([n for n, need in zip(names, pool._needs_reset)
                         if need], (t.clone() for t in pool._template_leaves)))
    for leaf in flatten_tree(pool.cache).values():
        leaf.add_(1.0)
    dirty = _clone(pool.cache)
    pool.reset([1])
    for (n, c), ax in zip(flatten_tree(pool.cache).items(),
                          pool.batch_axes):
        want = template[n] if n in template else dirty[n]
        assert torch.equal(c.select(ax, 1), want.select(ax, 1)), n
        for keep in (0, 2):
            assert torch.equal(c.select(ax, keep), dirty[n].select(ax, keep))
    assert pool.positions[1] == 0


# ---------------------------------------------------------------------------
# the entry points and the refusal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(ARCHS))
def test_generate_and_cli_match_reference(sessions, ref_sessions, family,
                                          tmp_path):
    """``session.generate``: the reference's prompts bitwise and its tokens
    (margins asserted); the CLI (``--smoke --device cpu``) on a checkpoint
    of the same weights gives the same tokens."""
    kw = dict(batch=3, prompt_len=4, new_tokens=5, max_len=MAX_LEN)
    ref, session = ref_sessions[family], sessions[family]
    ref_eng = ref.serve_engine(max_slots=3, max_len=MAX_LEN)
    with _capture(ref_eng, np.asarray) as log:
        want = ref.generate(**kw)
    got = session.generate(**kw)
    assert _assert_margins(log) == 3 * 5
    assert got["generated"] == want["generated"]
    assert (got["iterations"], got["occupancy"]) == (want["iterations"],
                                                     want["occupancy"])
    ckpt = str(tmp_path / "ckpt")
    session.checkpoint(ckpt)
    cli = serve.main(["--arch", ARCHS[family], "--smoke", "--device", "cpu",
                      "--ckpt", ckpt, "--batch", "3", "--prompt-len", "4",
                      "--tokens", "5", "--max-len", str(MAX_LEN)])
    assert cli["generated"] == want["generated"]


@pytest.mark.parametrize("arch", ["vit-base", "olmoe-1b-7b",
                                  "deepseek-v2-lite-16b", "whisper-base"])
def test_engine_refuses_families_without_a_decode_path(arch):
    """Encoder-only ViT and the families whose caches are not ported yet:
    ``ServeEngine`` raises, naming the families still to come."""
    cfg = get_config(arch).reduced()
    model = build(cfg, device="cpu")
    with pytest.raises(ValueError, match="no decode path in the port") as err:
        ServeEngine(model, cfg, model.params(), max_slots=2, max_len=16)
    for family in ("MoE", "MLA", "whisper", "VLM"):
        assert family in str(err.value)
    assert arch in str(err.value)
