"""The port's serving core (``serve/request.py``, ``cache_pool.py``,
``scheduler.py``, ``engine.py``) against the reference's ``ServeEngine``
(``prefix_sharing=False`` on both sides) on the same weights, then the
port against itself, mirroring ``tests/test_serve.py``.  Prefix sharing is
held in ``tests/test_torch_serve_prefix.py``.

Reduced configs through ``TrainConfig(smoke=True)`` (f32, an f32 cache);
the reference's weights carried over by ``params_from_numpy``; prompts
made from a numpy seed.  Against the reference, at one token an
iteration and in chunks (``prefill_chunk`` 2-5, with and without a
``token_budget``): the same tokens per rid, the same finish reasons, the
same ``iterations``, ``occupancy`` and ``to_dict`` keys, and in every
iteration the same path (chunk or decode), positions and consume counts
(host logic, exact).  The two sides' logits differ by other matmul and reduction stacks,
so equal tokens are held to a margin: every greedy step's top-2 margin in
the reference's logits is asserted above twice the f32 logit bound of
``tests/test_torch_decode.py`` (2e-5 of the row's largest |logit|), and
every sampled step's winning margin (logits over the temperature plus the
Gumbel draw) above the Gumbel bound of ``tests/test_torch_sampling.py``
plus that logit bound over the temperature (and a top-k row's k-th logit
above its (k+1)-th by the same share), so a near tie fails loudly instead
of flaking.

Within the port: a request alone through an engine of the same width is
bitwise (a row's arithmetic at a fixed width does not depend on its
neighbours; masked stale rows add exact zeros); against one slot (the
GEMMs' bits depend on their row count) the tokens are equal with the
batched run's margins asserted as above.  The ring cache's reset is
bitwise.  ``prefill_chunk=1`` is bitwise to the one-token iteration the
scheduler had before its chunk path; a chunked rerun is bitwise; a chunk
iteration leaves a stalled and a free slot's cache rows untouched.  Under
chunking a request is not bitwise to its solo run (a GEMM of C rows
rounds unlike one of 1), so its tokens are held to the reference's with
the margins asserted.  The construction errors carry the reference's
text.
"""
import contextlib
import datetime
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.qwen3_1_7b import SLIDING as REF_SWA
from repro.core import DPConfig as RefDPConfig
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.models.registry import build as ref_build
from repro.models.registry import get_config as ref_get_config
from repro.serve import Request as RefRequest
from repro.serve import SamplingParams as RefSamplingParams
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import cache_pool as ref_cache_pool
from repro.serve import engine as ref_engine
from repro.serve import request as ref_request
from repro_torch.configs import get_config
from repro_torch.configs.qwen3_1_7b import SLIDING
from repro_torch.core import DPConfig
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.launch.executor import LaunchConfig, MeshExecutor
from repro_torch.models import build
from repro_torch.resilience.faults import FaultInjected, FaultPlan, active
from repro_torch.serve import (CachePool, PrefixIndex, Request,
                               SamplingParams, ServeEngine,
                               latency_percentiles, percentiles,
                               ttft_percentiles)
from repro_torch.serve import cache_pool as port_cache_pool
from repro_torch.serve import engine as port_engine
from repro_torch.serve import request as port_request
from repro_torch.serve import sampling as S
from repro_torch.utils.params import params_from_numpy

MAX_LEN = 32
# tests/test_torch_decode.py's f32 logit bound and tests/test_torch_sampling.py's
# Gumbel bound
LOGIT_TOL = 2e-5
GUMBEL_ULP_BOUND = 4

# each mix: the engine width, the requests (prompt size, max_new_tokens,
# sampling (temperature, top_k, seed) or None) submitted first, the
# iterations run before the late ones are submitted, and the admission
MIXES = {
    # tests/test_serve.py:54: more requests than slots, retire + reuse
    "six": dict(width=4, early=list(zip([3, 7, 2, 5, 4, 6],
                                        [9, 3, 12, 5, 7, 4])), seed=0),
    # :72: a request admitted into a running batch
    "midflight": dict(width=3, early=[(4, 8), (6, 8)], seed=1, steps=5,
                      late=[(3, 6)], late_seed=2),
    # :113: a sampled request among greedy fillers
    "sampled": dict(width=4, early=[(4, 7, (0.8, 5, 11)), (3, 6), (5, 6),
                                    (6, 6)], seed=5),
    # :461: more requests than slots under static admission
    "static": dict(width=2, early=[(n, 3) for n in (3, 4, 2, 5, 3)],
                   seed=19, admission="static"),
    # a request that fills the cache (20 + 13 - 1 = 32 positions)
    "max_len": dict(width=4, early=[(20, 16), (5, 4)], seed=40),
    # :167: chunked prefill with a mid-flight admission, greedy and sampled
    **{f"chunk{c}": dict(width=3, early=[(9, 6), (4, 8)], seed=7, steps=3,
                         late=[(11, 5), (6, 7, (0.9, 4, 13))], late_seed=8,
                         chunk=c) for c in (1, 2, 3, 5)},
    # :245: a long prompt admitted mid-flight under a token budget
    "budget": dict(width=3, early=[(5, 10), (4, 10)], seed=11, steps=4,
                   late=[(14, 4)], late_seed=12, chunk=4, budget=5),
    # the budget stalls slot 1 (n_tok 0) while slot 0 takes it all
    "stall": dict(width=3, early=[(8, 3), (8, 3)], seed=13, chunk=4,
                  budget=4),
}
MIXES["max_len_c5"] = dict(MIXES["max_len"], chunk=5)
MIXES["static_c3"] = dict(MIXES["static"], chunk=3)


def _specs(mix, vocab):
    """[(rid, prompt, max_new, sampling or None)] of the early and the late
    requests."""
    out = []
    for key, seed in (("early", mix["seed"]), ("late", mix.get("late_seed"))):
        rng = np.random.RandomState(seed)
        for spec in mix.get(key, ()):
            out.append((len(out), rng.randint(0, vocab, size=spec[0]).tolist(),
                        spec[1], spec[2] if len(spec) > 2 else None))
    return out


def _request(spec, req_cls, sp_cls):
    rid, prompt, max_new, samp = spec
    sp = sp_cls() if samp is None else sp_cls(temperature=samp[0],
                                              top_k=samp[1], seed=samp[2])
    return req_cls(prompt=prompt, max_new_tokens=max_new, sampling=sp,
                   rid=rid)


def _drive(engine, mix, vocab, req_cls=Request, sp_cls=SamplingParams):
    """The mix through ``engine``: the early requests, ``steps``
    iterations, the late ones, then drain."""
    specs = _specs(mix, vocab)
    n_early = len(mix["early"])
    engine.scheduler.admission = mix.get("admission", "continuous")
    try:
        for spec in specs[:n_early]:
            engine.submit(_request(spec, req_cls, sp_cls))
        for _ in range(mix.get("steps", 0)):
            assert engine.step()
        for spec in specs[n_early:]:
            engine.submit(_request(spec, req_cls, sp_cls))
        return engine.run()
    finally:
        engine.scheduler.admission = "continuous"


def _by_rid(out, key="generated"):
    return {r["rid"]: r[key] for r in out["results"]}


def _key(name):
    """An engine's (width, prefill_chunk, token_budget) for a mix."""
    mix = MIXES[name]
    return mix["width"], mix.get("chunk", 1), mix.get("budget")


@contextlib.contextmanager
def _capture(engine, to_numpy):
    """Record every step of ``engine`` (``decode_fn`` and ``prefill_fn``)
    as dict(path "decode" or "chunk", pos (B,), n_tok (B,), the decoding
    slots, logits (B, V) f64, rows [(slot, SamplingParams, last consumed
    position)] that sample from it).  A decode step consumes one token in
    every active slot."""
    log = []
    inner = engine.decode_fn, engine.prefill_fn

    def record(path, logits, pos, n_tok):
        act = engine.scheduler.active
        if n_tok is None:
            n_tok = np.zeros(len(pos), np.int32)
            n_tok[list(act)] = 1
        else:
            n_tok = np.asarray(to_numpy(n_tok))
        rows = [(slot, st.request.sampling, st.pos + int(n_tok[slot]) - 1)
                for slot, st in act.items() if n_tok[slot]
                and st.wants_sample_at(st.pos + int(n_tok[slot]) - 1)]
        log.append(dict(path=path, pos=np.asarray(to_numpy(pos)),
                        n_tok=n_tok, rows=rows,
                        decoding=sorted(slot for slot, st in act.items()
                                        if st.pos >= st.prompt_len),
                        logits=np.asarray(to_numpy(logits), np.float64)))

    def decode(params, cache, tok, pos):
        logits, cache = inner[0](params, cache, tok, pos)
        record("decode", logits, pos, None)
        return logits, cache

    def prefill(params, cache, tok, pos, n_tok):
        logits, cache = inner[1](params, cache, tok, pos, n_tok)
        record("chunk", logits, pos, n_tok)
        return logits, cache

    engine.decode_fn = decode
    if inner[1] is not None:
        engine.prefill_fn = prefill
    try:
        yield log
    finally:
        engine.decode_fn, engine.prefill_fn = inner


def _assert_margins(log):
    """Every sampled position's margin above what the logit bound (and the
    Gumbel bound) can move; returns the number of positions held."""
    n = 0
    for step in log:
        for slot, sp, pos in step["rows"]:
            row = step["logits"][slot]
            tol = 2 * LOGIT_TOL * np.abs(row).max()
            if sp.temperature == 0:
                top2 = np.sort(row)[-2:]
                assert top2[1] - top2[0] > tol, (slot, pos)
            else:
                lt = torch.from_numpy(row).float() / sp.temperature
                srt = torch.sort(lt, descending=True).values
                k = sp.top_k or len(row)
                if k < len(row):
                    assert float(srt[k - 1] - srt[k]) > tol / sp.temperature
                g = S.gumbel(S.fold_in(S.prng_key(torch.tensor([sp.seed])),
                                       torch.tensor([pos])), len(row))[0]
                z = torch.where(lt >= srt[k - 1], lt + g, -torch.inf)
                top2 = torch.topk(z, 2).values
                slack = (2 * GUMBEL_ULP_BOUND * float(np.spacing(np.float32(
                    max(float(top2[0].abs()), 1.0))))
                    + tol / sp.temperature)
                assert float(top2[0] - top2[1]) > slack, (slot, pos)
            n += 1
    return n


# ---------------------------------------------------------------------------
# fixtures: one reference session, the port's session on its weights, and
# each engine built once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_qwen():
    return RefSession.from_config(
        "qwen2-0.5b", RefDPConfig(engine="nonprivate"),
        RefTrainConfig(seed=0, smoke=True))


@pytest.fixture(scope="module")
def qwen(ref_qwen):
    params = params_from_numpy(jax.tree.map(np.asarray,
                                            ref_qwen.state.params), "cpu")
    return PrivacySession.from_config(
        "qwen2-0.5b", DPConfig(engine="nonprivate"),
        TrainConfig(seed=0, smoke=True), device="cpu", params=params)


@pytest.fixture(scope="module")
def ref_engines(ref_qwen):
    made = {}

    def get(width, chunk=1, budget=None):
        if (width, chunk, budget) not in made:
            made[width, chunk, budget] = RefServeEngine.from_session(
                ref_qwen, max_slots=width, max_len=MAX_LEN,
                prefill_chunk=chunk, token_budget=budget,
                prefix_sharing=False)
        return made[width, chunk, budget]
    return get


@pytest.fixture(scope="module")
def engines(qwen):
    made = {}

    def get(width, chunk=1, budget=None):
        if (width, chunk, budget) not in made:
            made[width, chunk, budget] = ServeEngine.from_session(
                qwen, max_slots=width, max_len=MAX_LEN, prefill_chunk=chunk,
                token_budget=budget, prefix_sharing=False)
        return made[width, chunk, budget]
    return get


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MIXES))
def test_mix_matches_reference(qwen, ref_engines, engines, name):
    """The same tokens, finish reasons, iterations and occupancy, and in
    every iteration the same path, positions and consume counts (host
    logic: exact)."""
    mix = MIXES[name]
    vocab = qwen.model_cfg.vocab
    ref = ref_engines(*_key(name))
    with _capture(ref, np.asarray) as log:
        want = _drive(ref, mix, vocab, RefRequest, RefSamplingParams)
    eng = engines(*_key(name))
    with _capture(eng, lambda t: t.numpy()) as got_log:
        got = _drive(eng, mix, vocab)
    assert _assert_margins(log) == sum(len(g) for g in
                                       _by_rid(want).values())
    assert _by_rid(got) == _by_rid(want)
    assert _by_rid(got, "finish_reason") == _by_rid(want, "finish_reason")
    assert got["iterations"] == want["iterations"]
    # run() counts the drain; the log holds the early steps too
    assert len(log) == want["iterations"] + mix.get("steps", 0)
    assert got["occupancy"] == want["occupancy"]
    assert len(got_log) == len(log)
    for i, (g, w) in enumerate(zip(got_log, log)):
        assert g["path"] == w["path"], i
        np.testing.assert_array_equal(g["pos"], w["pos"], err_msg=str(i))
        np.testing.assert_array_equal(g["n_tok"], w["n_tok"],
                                      err_msg=str(i))
        assert g["decoding"] == w["decoding"], i
        assert [r[::2] for r in g["rows"]] == [r[::2] for r in w["rows"]]
    width, chunk, budget = _key(name)
    paths = {w["path"] for w in log}
    assert paths == ({"decode"} if chunk == 1 else {"decode", "chunk"})
    for w in log:
        # a decoder takes exactly one token; the budget caps the rest
        assert (w["n_tok"][w["decoding"]] == 1).all()
        if budget is not None:
            assert w["n_tok"].sum() <= max(budget, len(w["decoding"]))
    assert set(got) - {"phase_breakdown"} == set(want) - {"phase_breakdown"}
    for g, w in zip(got["results"], want["results"]):
        assert list(g) == list(w)
    assert got["prefix_hits"] == got["prefix_tokens_shared"] == 0
    assert got["launch"] == want["launch"] == {"executor": "local"}
    if name == "max_len":
        assert _by_rid(got, "finish_reason")[0] == "max_len"
        assert len(_by_rid(got)[0]) == MAX_LEN - 20 + 1
    if name.startswith("chunk") and chunk > 1:
        # prompts really were consumed several tokens an iteration
        assert got["iterations"] < sum(len(p) + n - 1 for _, p, n, _ in
                                       _specs(mix, vocab))
    if name == "budget":
        # two decoders hold 2 of the 5 tokens: the late 14-token prompt
        # takes at most 3 an iteration
        assert got["iterations"] + mix["steps"] > 14 // 3
    if name == "stall":
        assert log[0]["n_tok"].tolist() == [4, 0, 0]


def test_request_module_matches_reference():
    """Constants, validation, the timing helpers and ``to_dict``'s keys;
    the percentile helpers on the same values."""
    for name in ("QUEUED", "PREFILL", "DECODE", "FINISHED", "FINISH_LENGTH",
                 "FINISH_MAX_LEN", "FINISH_ERROR", "FINISH_CANCELLED"):
        assert getattr(port_request, name) == getattr(ref_request, name)
    for bad in (dict(temperature=-1.0), dict(top_k=-1)):
        with pytest.raises(ValueError):
            SamplingParams(**bad).validate()
    with pytest.raises(ValueError, match="empty prompt"):
        Request(prompt=[])
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(prompt=[1], max_new_tokens=0)
    st, rst = (mod.RequestState(cls(prompt=[1, 2, 3], rid=7))
               for mod, cls in ((port_request, Request),
                                (ref_request, RefRequest)))
    for s in (st, rst):
        s.submitted_at, s.admitted_at, s.first_token_at = 10.0, 10.5, 11.0
        s.generated = [4, 5, 6]
        s.finish("length")
        s.finished_at = 12.0
    assert st.to_dict() == rst.to_dict()
    assert [st.wants_sample_at(p) for p in range(4)] == \
        [rst.wants_sample_at(p) for p in range(4)] == [False, False, True,
                                                       True]
    vals = [0.3, None, 0.1, 0.7, 0.2, 0.9, 0.4]
    assert percentiles(vals) == ref_engine.percentiles(vals)
    assert percentiles([]) == ref_engine.percentiles([]) == (0.0, 0.0)
    results = [dict(latency_s=v, ttft_s=v) for v in vals if v is not None]
    assert latency_percentiles(results) == \
        ref_engine.latency_percentiles(results)
    assert ttft_percentiles(results) == ref_engine.ttft_percentiles(results)
    assert port_engine._PHASE_SPANS == ref_engine._PHASE_SPANS


# ---------------------------------------------------------------------------
# within the port (tests/test_serve.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("against", ["same_width", "one_slot"])
@pytest.mark.parametrize("name", ["six", "midflight", "sampled"])
def test_batch_matches_alone(qwen, engines, name, against):
    """Each request of the mix alone: through an engine of the same width
    (the others idle) bitwise, through one slot with the batched run's
    margins asserted."""
    mix = MIXES[name]
    vocab = qwen.model_cfg.vocab
    eng = engines(mix["width"])
    if against == "one_slot":
        with _capture(eng, lambda t: t.numpy()) as log:
            out = _drive(eng, mix, vocab)
        _assert_margins(log)
        solo = engines(1)
    else:
        out = _drive(eng, mix, vocab)
        solo = eng
    gen = _by_rid(out)
    assert len(gen) == len(_specs(mix, vocab))
    for spec in _specs(mix, vocab):
        alone = solo.run([_request(spec, Request, SamplingParams)])
        assert alone["results"][0]["generated"] == gen[spec[0]], spec[0]
    if name != "midflight":
        # more requests than slots: the scheduler retired and readmitted
        assert out["iterations"] < sum(len(p) + n - 1
                                       for _, p, n, _ in _specs(mix, vocab))


def test_topk1_is_greedy(qwen, engines):
    solo = engines(1)
    prompt = np.random.RandomState(5).randint(0, qwen.model_cfg.vocab,
                                              size=4).tolist()
    greedy = solo.run([Request(prompt=prompt, max_new_tokens=7)])
    topk1 = solo.run([Request(prompt=prompt, max_new_tokens=7,
                              sampling=SamplingParams(temperature=1.3,
                                                      top_k=1, seed=9))])
    assert greedy["results"][0]["generated"] == \
        topk1["results"][0]["generated"]


def test_cache_pool_insert_evict_positions(qwen):
    pool = CachePool(qwen.model, qwen.state.params, 3, 16)
    assert [pool.insert() for _ in range(3)] == [0, 1, 2]
    assert pool.insert() is None and pool.n_free == 0
    pool.evict(1)
    with pytest.raises(ValueError):
        pool.evict(1)
    assert pool.insert() == 1
    pool.positions[:] = [2, 5, 1]       # scheduler sync point
    pool.reset([1])
    assert pool.positions.tolist() == [2, 0, 1]
    # position-masked KV caches reset for free: no template leaves retained
    assert pool._needs_reset == [False] * len(pool._needs_reset)
    assert pool._template_leaves == []
    assert pool.supports_prefix_sharing
    assert isinstance(pool.prefix_index, PrefixIndex)


def test_pool_rejects_oversized_prompt(qwen):
    engine = ServeEngine.from_session(qwen, max_slots=1, max_len=8)
    with pytest.raises(ValueError):
        engine.submit(Request(prompt=list(range(8)), max_new_tokens=2))


def test_pool_evict_then_insert_same_iteration(qwen):
    """Evict-then-insert in the same scheduler iteration reuses the slot
    with a clean position: no leak from the previous occupant."""
    pool = CachePool(qwen.model, qwen.state.params, 2, 16)
    a, b = pool.insert(), pool.insert()
    pool.positions[:] = [7, 3]          # mid-flight positions
    pool.evict(a)
    c = pool.insert()                   # same iteration: lowest free slot
    assert c == a
    assert pool.positions[c] == 0       # position not leaked
    assert pool.positions[b] == 3       # neighbour untouched
    pool.reset([c])
    assert pool.positions.tolist() == [0, 3]


def test_full_pool_static_admission_queues(qwen):
    """More submissions than slots under admission="static" queue (drain by
    group) rather than raise; every request still finishes."""
    engine = ServeEngine(qwen.model, qwen.model_cfg, qwen.state.params,
                         max_slots=2, max_len=MAX_LEN, admission="static")
    vocab = qwen.model_cfg.vocab
    rng = np.random.RandomState(19)
    for n in (3, 4, 2, 5, 3):
        engine.submit(Request(prompt=rng.randint(0, vocab, size=n).tolist(),
                              max_new_tokens=3))
    assert len(engine.scheduler.queue) == 5
    out = engine.run()
    assert len(out["results"]) == 5
    assert all(r["finish_reason"] == "length" for r in out["results"])


def test_detect_batch_axes_ambiguous_leaf_error():
    """A cache leaf whose shape changes along TWO axes with the batch size
    has no unique batch axis: the probe must say so, not pick one."""
    class BadModel:
        def init_cache(self, params, B, S, dtype=None):
            return {"kv": torch.zeros((B, B, S, 4), device="meta")}

    with pytest.raises(ValueError, match="no unique batch axis"):
        port_cache_pool.detect_batch_axes(BadModel(), {}, 16, None)


def test_mid_iteration_exception_recovers_slots(qwen):
    """A raise mid-iteration (after the step, before retirement) must evict
    every in-flight slot, finish the requests with FINISH_ERROR, leave the
    pool consistent, and leave the engine usable for the next batch."""
    vocab = qwen.model_cfg.vocab
    engine = ServeEngine.from_session(qwen, max_slots=3, max_len=MAX_LEN)
    rng = np.random.RandomState(31)
    reqs = [Request(prompt=rng.randint(0, vocab, size=n).tolist(),
                    max_new_tokens=4) for n in (3, 5, 4)]
    plan = FaultPlan.single("serve/mid_iteration", action="raise", at=2)
    with active(plan), pytest.raises(FaultInjected):
        engine.run(reqs)
    assert plan.fired == ["serve/mid_iteration"]
    sch = engine.scheduler
    assert not sch.active                       # nobody left in flight
    assert engine.pool.n_free == 3              # every slot returned
    assert not engine.pool.occupied
    engine.pool.assert_consistent()
    errored = [s for s in sch.finished if s.finish_reason == "error"]
    assert len(errored) == 3
    # the engine is not poisoned: a fresh batch runs to completion
    sch.finished = []
    rng = np.random.RandomState(32)
    out = engine.run([Request(prompt=rng.randint(0, vocab, size=n).tolist(),
                              max_new_tokens=3) for n in (4, 2)])
    assert len(out["results"]) == 2
    assert all(r["finish_reason"] == "length" for r in out["results"])


def test_cancel_queued_and_active(qwen):
    """cancel(rid): queued requests never claim a slot; active ones retire
    with their slot evicted and partial output kept."""
    vocab = qwen.model_cfg.vocab
    engine = ServeEngine.from_session(qwen, max_slots=1, max_len=MAX_LEN)
    active_st = engine.submit(Request(
        prompt=np.random.RandomState(34).randint(0, vocab, size=3).tolist(),
        max_new_tokens=8))
    queued_st = engine.submit(Request(
        prompt=np.random.RandomState(35).randint(0, vocab, size=4).tolist(),
        max_new_tokens=8))
    for _ in range(4):                          # first request decoding,
        engine.step()                           # second stuck in queue
    sch = engine.scheduler
    assert sch.cancel(queued_st.rid)
    assert queued_st.finish_reason == "cancelled"
    assert not sch.queue
    n_before = len(active_st.generated)
    assert n_before >= 1
    assert sch.cancel(active_st.rid)
    assert active_st.finish_reason == "cancelled"
    assert len(active_st.generated) == n_before     # partial output kept
    assert not sch.active and engine.pool.n_free == 1
    engine.pool.assert_consistent()
    assert not sch.cancel(queued_st.rid)            # already finished
    assert not sch.cancel(10_000)                   # unknown rid


def test_assert_consistent_catches_violations(qwen):
    """The consistency check fails on each class of corruption it covers,
    the prefix index's stale entries included."""
    pool = CachePool(qwen.model, qwen.state.params, 2, 16)
    s = pool.insert()
    pool.assert_consistent()

    pool._free.append(s)                            # slot both free+occupied
    with pytest.raises(AssertionError, match="nonzero|pinned|duplicate|free"):
        pool.positions[s] = 3
        pool.assert_consistent()
    pool._free.remove(s)
    pool.positions[s] = 0

    pool._refcount[s] = -1                          # unbalanced unpin
    with pytest.raises(AssertionError, match="negative refcount"):
        pool.assert_consistent()
    pool._refcount[s] = 0

    pool.prefix_index.register(1 - s, [1, 2, 3])    # registered but free
    with pytest.raises(AssertionError, match="prefix index"):
        pool.assert_consistent()
    pool.prefix_index.unregister(1 - s)
    pool.assert_consistent()


# ---------------------------------------------------------------------------
# ring caches (a sliding window: no position axis, so every leaf resets)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def swa():
    return PrivacySession.from_config(
        SLIDING, DPConfig(engine="nonprivate"),
        TrainConfig(seed=0, smoke=True), device="cpu")


def test_ring_cache_reset_restores_slots_bitwise(swa):
    pool = CachePool(swa.model, swa.state.params, 3, MAX_LEN)
    assert pool._needs_reset == [True, True]      # blocks.k, blocks.v
    assert not pool.supports_prefix_sharing
    pool.insert()
    pool.insert()
    template = [t.clone() for t in pool._template_leaves]
    for leaf in pool.cache["blocks"].values():
        leaf.add_(torch.randn(leaf.shape, generator=torch.Generator()
                              .manual_seed(0)))
    dirty = [pool.cache["blocks"][n].clone() for n in ("k", "v")]
    pool.reset([1])
    for n, t, d, ax in zip(("k", "v"), template, dirty, pool.batch_axes):
        c = pool.cache["blocks"][n]
        assert torch.equal(c.select(ax, 1), t.select(ax, 1))
        for keep in (0, 2):
            assert torch.equal(c.select(ax, keep), d.select(ax, keep))
    assert pool.positions[1] == 0


def test_ring_slot_reuse_does_not_leak(swa):
    """The same probe before and after churn past the window through the
    same slots gives the same tokens."""
    vocab = swa.model_cfg.vocab
    engine = ServeEngine.from_session(swa, max_slots=2, max_len=MAX_LEN)
    probe = Request(prompt=np.random.RandomState(3).randint(
        0, vocab, size=4).tolist(), max_new_tokens=6)
    first = engine.run([probe])["results"][0]["generated"]
    rng = np.random.RandomState(4)
    churn = engine.run([Request(prompt=rng.randint(0, vocab, size=n)
                                .tolist(), max_new_tokens=12)
                        for n in (10, 12, 6)])
    assert all(r["prompt_len"] + len(r["generated"]) - 1
               > swa.model_cfg.sliding_window
               for r in churn["results"][:2])      # the ring wrapped
    again = engine.run([probe])["results"][0]["generated"]
    assert first == again, "slot reuse leaked state across requests"


# ---------------------------------------------------------------------------
# probes, placement, what is not ported
# ---------------------------------------------------------------------------

def _probe_pair(name):
    if name == "qwen3-1.7b-swa":
        return REF_SWA.reduced(), SLIDING.reduced()
    return ref_get_config(name).reduced(), get_config(name).reduced()


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-1.7b", "llama3.2-3b",
                                  "qwen3-1.7b-swa"])
def test_probe_axes_match_reference(name):
    rcfg, cfg = _probe_pair(name)
    rmodel = ref_build(rcfg)
    rparams = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    model = build(cfg, device="cpu")
    params = model.params()
    for fn in ("detect_batch_axes", "detect_pos_axes"):
        want = getattr(ref_cache_pool, fn)(rmodel, rparams, 24, jnp.float32,
                                           {})
        got = getattr(port_cache_pool, fn)(model, params, 24, torch.float32)
        assert got == want, fn


def test_probe_allocates_nothing(qwen, monkeypatch):
    """Every probe hands init_cache meta params; only the pool's own cache
    is made on the params' device."""
    seen = []
    inner = qwen.model.init_cache

    def spy(params, B, S, **kw):
        seen.append((B, S, {p.device.type for p in params.values()}))
        return inner(params, B, S, **kw)

    monkeypatch.setattr(qwen.model, "init_cache", spy)
    shapes = port_cache_pool._probe_cache_shapes(
        qwen.model, qwen.state.params, 2, 16, torch.float32)
    assert shapes == [torch.Size((2, 2, 16, 2, 32))] * 2
    pool = CachePool(qwen.model, qwen.state.params, 3, 16)
    assert [s[:2] for s in seen] == [(2, 16), (2, 16), (3, 16), (2, 16),
                                     (2, 17), (3, 16)]
    assert all(dev == {"meta"} for _, _, dev in seen[:-1])
    assert seen[-1][2] == {"cpu"}
    assert pool.cache["blocks"]["k"].device.type == "cpu"


def test_mesh_executor_serving_raises(qwen, tmp_path):
    """Serving across ranks is not ported: a mesh executor refuses the
    pool's cache instead of serving on one rank."""
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = MeshExecutor(LaunchConfig(mesh=(1,)))
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            ServeEngine(qwen.model, qwen.model_cfg, qwen.state.params,
                        executor=mesh, max_slots=2, max_len=16)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# chunked prefill and the token budget within the port
# ---------------------------------------------------------------------------

def _one_token_iteration(sch, obs):
    """The scheduler's iteration as it was before the chunk path: every
    active slot consumes one token through one ``decode_step``, sampled at
    its position.  ``prefill_chunk=1`` must match it bitwise."""
    eng, pool = sch.engine, sch.engine.pool
    B = pool.max_slots
    tok = torch.zeros(B, 1, dtype=torch.int32)
    pos, seeds, topks = (torch.zeros(B, dtype=torch.int32) for _ in range(3))
    temps = torch.zeros(B)
    for slot, st in sch.active.items():
        tok[slot, 0] = (st.prompt[st.pos] if st.pos < st.prompt_len
                        else st.generated[-1])
        pos[slot] = st.pos
        sp = st.request.sampling
        seeds[slot], topks[slot], temps[slot] = (sp.seed, sp.top_k,
                                                 sp.temperature)
    pool.positions[:] = pos.numpy()
    logits, pool.cache = eng.decode_fn(eng.params, pool.cache, tok, pos)
    next_tok = (eng.sample_fn(logits, pos, seeds, temps, topks)
                if temps.any() else eng.greedy_fn(logits)).numpy()
    sch.iterations += 1
    sch.active_slot_steps += len(sch.active)
    sch.tokens_consumed += len(sch.active)
    for slot, st in list(sch.active.items()):
        if st.wants_sample_at(st.pos):
            st.generated.append(int(next_tok[slot]))
            st.first_token_at = st.first_token_at or time.time()
        st.pos += 1
        if len(st.generated) >= st.request.max_new_tokens:
            st.finish("length")
        elif st.pos >= eng.max_len:
            st.finish("max_len")
        if st.finished_at is not None:
            del sch.active[slot]
            pool.evict(slot)
            sch.finished.append(st)
    return True


def _same_steps(a, b):
    """Two captures of one mix: the same paths, positions, consume counts
    and logits, bitwise."""
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x["path"] == y["path"], i
        for k in ("pos", "n_tok", "logits"):
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("name", ["six", "midflight", "sampled", "static",
                                  "chunk1"])
def test_chunk1_bitwise_to_one_token_iteration(qwen, engines, name):
    """``prefill_chunk=1`` never takes the chunk path, and every iteration
    (logits, tokens, iterations, occupancy) is bitwise to the one-token
    scheduler's."""
    mix, vocab = MIXES[name], qwen.model_cfg.vocab
    eng = engines(mix["width"])
    assert eng.prefill_fn is None and eng.prefix_sharing is False
    with _capture(eng, lambda t: t.numpy()) as log:
        got = _drive(eng, mix, vocab)
    eng.scheduler._step_active = types.MethodType(_one_token_iteration,
                                                  eng.scheduler)
    try:
        with _capture(eng, lambda t: t.numpy()) as old_log:
            old = _drive(eng, mix, vocab)
    finally:
        del eng.scheduler._step_active
    assert {x["path"] for x in log} == {"decode"}
    _same_steps(log, old_log)
    assert _by_rid(got) == _by_rid(old)
    assert _by_rid(got, "finish_reason") == _by_rid(old, "finish_reason")
    assert (got["iterations"], got["occupancy"]) == (old["iterations"],
                                                     old["occupancy"])


@pytest.mark.parametrize("name", ["chunk3", "budget", "max_len_c5"])
def test_chunked_rerun_bitwise(qwen, engines, name):
    """The same chunked mix twice through one engine (the second over the
    first's stale rows): every iteration and token bitwise."""
    mix, vocab = MIXES[name], qwen.model_cfg.vocab
    eng = engines(*_key(name))
    runs = []
    for _ in range(2):
        with _capture(eng, lambda t: t.numpy()) as log:
            runs.append((_drive(eng, mix, vocab), log))
    (first, a), (again, b) = runs
    assert "chunk" in {x["path"] for x in a}
    _same_steps(a, b)
    assert _by_rid(first) == _by_rid(again)
    assert first["iterations"] == again["iterations"]


def test_stalled_and_free_rows_untouched(qwen, engines):
    """A chunk iteration leaves the cache rows of a slot stalled under the
    budget (n_tok 0) and of a free slot bitwise unchanged, and writes the
    consuming slot's rows [pos, pos + n_tok) only."""
    eng = engines(*_key("stall"))
    seen, inner = [], eng.prefill_fn

    def prefill(params, cache, tok, pos, n_tok):
        before = {k: c.clone() for k, c in cache["blocks"].items()}
        logits, cache = inner(params, cache, tok, pos, n_tok)
        end = int(pos[0] + n_tok[0])
        seen.append((n_tok.tolist(), pos.tolist(), {
            k: [torch.equal(c[:, s], before[k][:, s]) for s in range(3)]
            + [torch.equal(c[:, 0, end:], before[k][:, 0, end:])]
            for k, c in cache["blocks"].items()}))
        return logits, cache

    eng.prefill_fn = prefill
    try:
        _drive(eng, MIXES["stall"], qwen.model_cfg.vocab)
    finally:
        eng.prefill_fn = inner
    n_tok, pos, same = seen[0]
    assert n_tok == [4, 0, 0] and pos == [0, 0, 0]
    for k in ("k", "v"):
        # slot 0 written, slots 1 (stalled) and 2 (free) untouched, slot 0
        # past its 4 tokens untouched
        assert same[k] == [False, True, True, True], k


def _no_prefill_model(model):
    return types.SimpleNamespace(decode_step=model.decode_step)


@pytest.mark.parametrize("case", ["chunk_below_1", "no_prefill_step",
                                  "sliding_window", "budget_needs_chunk",
                                  "budget_below_1"])
def test_construction_errors_match_reference(qwen, ref_qwen, swa, case):
    """The engine's four ValueErrors and the scheduler's, in the
    reference's order and with its text."""
    sides = []
    for sess, eng_cls, rcfg in ((qwen, ServeEngine, None),
                                (ref_qwen, RefServeEngine, REF_SWA)):
        model, cfg, params = sess.model, sess.model_cfg, sess.state.params
        kw = dict(max_slots=2, max_len=16)
        if case == "chunk_below_1":
            kw.update(prefill_chunk=0)
        elif case == "no_prefill_step":
            model = _no_prefill_model(model)
            kw.update(prefill_chunk=2)
        elif case == "sliding_window":
            if rcfg is None:
                model, cfg, params = swa.model, swa.model_cfg, None
            else:
                cfg = rcfg.reduced()
                model, params = ref_build(cfg), None
            kw.update(prefill_chunk=2)
        elif case == "budget_needs_chunk":
            kw.update(token_budget=4)
        else:
            kw.update(prefill_chunk=2, token_budget=0)
        with pytest.raises(ValueError) as err:
            eng_cls(model, cfg, params, **kw)
        sides.append(str(err.value))
    assert sides[0] == sides[1]
    if case == "sliding_window":
        assert "sliding-window" in sides[0]
        # prefill_chunk=1 (prefill-by-decode) stays available
        eng = ServeEngine.from_session(swa, max_slots=2, max_len=16)
        out = eng.run([Request(prompt=[1, 2, 3], max_new_tokens=2)])
        assert len(out["results"][0]["generated"]) == 2
