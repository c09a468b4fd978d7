"""Prefix sharing in the port's serving core (``serve/cache_pool.py``
``PrefixIndex`` and ``share_prefix``, the scheduler's admission with
sharing, ``ServeEngine(prefix_sharing=True)``) against the reference's, then
within the port, mirroring the prefix cases of ``tests/test_serve.py``.

Reduced qwen2 (f32, an f32 cache) with the reference's weights carried
over, as in ``tests/test_torch_serve.py``, whose capture and margin helpers
this file uses.  Against the reference, with sharing on in both packages:
``test_prefix_sharing_matches_solo``'s mix at ``prefill_chunk`` 1 and 2
gives the same tokens per rid (every sampled position's margin asserted in
the reference's logits), the same ``prefix_hits``, ``prefix_tokens_shared``,
``prefix_hit_rate``, ``iterations`` and ``occupancy``, and in every
iteration the same path, positions and consume counts; the sliding
window's ring refuses to share on both sides.  The ``PrefixIndex`` answers
the reference's on seeded random register/unregister/lookup sequences.

Within the port: at ``prefill_chunk=1`` sharing on is bitwise to sharing
off, per rid, in tokens and in each first-token logits row (rows copied
from the source are the bits the sharer would have written itself: a
row's arithmetic at a fixed width does not depend on its neighbours);
``share_prefix`` copies rows [0, depth) bitwise and leaves every row past
``depth`` and every other slot untouched, on f32 and bf16 caches; the
pin, park and unpin contract; a failed admission requeues the request and
frees its slot.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.qwen3_1_7b import SLIDING as REF_SWA
from repro.core import DPConfig as RefDPConfig
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.serve import Request as RefRequest
from repro.serve import SamplingParams as RefSamplingParams
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.cache_pool import PrefixIndex as RefPrefixIndex
from repro_torch.configs.qwen3_1_7b import SLIDING
from repro_torch.core import DPConfig
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (CachePool, PrefixIndex, Request,
                               SamplingParams, ServeEngine)
from repro_torch.utils.params import params_from_numpy
from test_torch_serve import _assert_margins, _by_rid, _capture

MAX_LEN = 32


def _prompts(vocab, sizes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=s).tolist() for s in sizes]


def _shared_mix(vocab):
    """``test_prefix_sharing_matches_solo``'s mix as [(prompt, max_new,
    sampling (temperature, top_k, seed) or None)]: r1 alone for 12
    iterations, then r2 (r1's first 7 tokens and a tail) and r3 (its
    first 4, sampled)."""
    base = _prompts(vocab, [10], 14)[0]
    return dict(width=2, steps=12, early=[(base, 12, None)],
                late=[(base[:7] + _prompts(vocab, [3], 15)[0], 6, None),
                      (base[:4] + _prompts(vocab, [2], 16)[0], 5,
                       (0.7, 3, 21))])


def _fan_mix(vocab):
    """Four requests on a 12-token prefix with tails of 2-5 tokens, one
    sampled, three submitted once the first decodes, through 3 slots."""
    rng = np.random.RandomState(23)
    pre = rng.randint(0, vocab, size=12).tolist()
    tails = [rng.randint(0, vocab, size=n).tolist() for n in (3, 2, 5, 4)]
    return dict(width=3, steps=14, early=[(pre + tails[0], 6, None)],
                late=[(pre + tails[1], 5, None),
                      (pre + tails[2], 4, (0.8, 5, 31)),
                      (pre + tails[3], 6, None)])


def _drive(engine, mix, req_cls=Request, sp_cls=SamplingParams):
    """The mix's early requests, ``steps`` iterations, the late ones, then
    drain; rids in submission order."""
    def req(rid, spec):
        prompt, max_new, samp = spec
        sp = sp_cls() if samp is None else sp_cls(
            temperature=samp[0], top_k=samp[1], seed=samp[2])
        return req_cls(prompt=prompt, max_new_tokens=max_new, sampling=sp,
                       rid=rid)

    specs = mix["early"] + mix["late"]
    for rid, spec in enumerate(mix["early"]):
        engine.submit(req(rid, spec))
    for _ in range(mix["steps"]):
        assert engine.step()
    for rid, spec in enumerate(mix["late"], start=len(mix["early"])):
        engine.submit(req(rid, spec))
    out = engine.run()
    assert len(out["results"]) == len(specs)
    return out


def _first_rows(engine):
    """Record each request's first-token logits row by rid (a wrapper of
    ``decode_fn``; the engines here run at ``prefill_chunk=1``)."""
    rows, inner = {}, engine.decode_fn
    sch = engine.scheduler

    def decode(params, cache, tok, pos):
        logits, cache = inner(params, cache, tok, pos)
        for slot, st in sch.active.items():
            if st.wants_sample_at(st.pos) and not st.generated:
                rows[st.rid] = logits[slot].clone()
        return logits, cache

    engine.decode_fn = decode
    return rows


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


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 2])
def test_prefix_sharing_matches_reference(qwen, ref_qwen, chunk):
    """Sharing on in both packages: the same tokens (margins asserted),
    hits, shared tokens, hit rate, iterations, occupancy, and in every
    iteration the same path, positions and consume counts."""
    mix = _shared_mix(qwen.model_cfg.vocab)
    ref = RefServeEngine.from_session(ref_qwen, max_slots=mix["width"],
                                      max_len=MAX_LEN, prefill_chunk=chunk)
    eng = ServeEngine.from_session(qwen, max_slots=mix["width"],
                                   max_len=MAX_LEN, prefill_chunk=chunk,
                                   obs=MetricsRegistry("events"))
    assert ref.prefix_sharing and eng.prefix_sharing
    with _capture(ref, np.asarray) as log:
        want = _drive(ref, mix, RefRequest, RefSamplingParams)
    with _capture(eng, lambda t: t.numpy()) as got_log:
        got = _drive(eng, mix)
    assert _assert_margins(log) == sum(len(g) for g in
                                       _by_rid(want).values())
    assert _by_rid(got) == _by_rid(want)
    for k in ("prefix_hits", "prefix_tokens_shared", "prefix_hit_rate",
              "iterations", "occupancy"):
        assert got[k] == want[k], k
    assert _by_rid(got, "prefix_tokens") == _by_rid(want, "prefix_tokens")
    assert got["prefix_hits"] >= 2 and got["prefix_tokens_shared"] >= 7 + 4
    assert eng.obs.counters["serve/prefix_hits"] == got["prefix_hits"]
    assert len(got_log) == len(log)
    for i, (g, w) in enumerate(zip(got_log, log)):
        assert g["path"] == w["path"], i
        np.testing.assert_array_equal(g["pos"], w["pos"], err_msg=str(i))
        np.testing.assert_array_equal(g["n_tok"], w["n_tok"],
                                      err_msg=str(i))
        assert [r[::2] for r in g["rows"]] == [r[::2] for r in w["rows"]]
    eng.pool.assert_consistent()


def test_prefix_sharing_refused_on_sliding_window():
    """The ring has no position axis, so both pools refuse to share: no
    index, no hit, and the tokens of the reference's (margins asserted)."""
    ref_s = RefSession.from_config(REF_SWA, RefDPConfig(engine="nonprivate"),
                                   RefTrainConfig(seed=0, smoke=True))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_s.state.params),
                               "cpu")
    swa = PrivacySession.from_config(
        SLIDING, DPConfig(engine="nonprivate"),
        TrainConfig(seed=0, smoke=True), device="cpu", params=params)
    vocab = swa.model_cfg.vocab
    base = _prompts(vocab, [8], 17)[0]
    mix = dict(steps=9, early=[(base, 10, None)],
               late=[(base[:6] + _prompts(vocab, [2], 18)[0], 5, None)])
    outs = []
    for sess, cls, req, sp, to_np in (
            (ref_s, RefServeEngine, RefRequest, RefSamplingParams,
             np.asarray),
            (swa, ServeEngine, Request, SamplingParams, lambda t: t.numpy())):
        engine = cls.from_session(sess, max_slots=2, max_len=MAX_LEN,
                                  prefix_sharing=True)
        assert not engine.prefix_sharing
        assert not engine.pool.supports_prefix_sharing
        assert engine.pool.prefix_index is None
        with _capture(engine, to_np) as log:
            outs.append((_drive(engine, mix, req, sp), log))
    (want, log), (got, _) = outs
    _assert_margins(log)
    assert _by_rid(got) == _by_rid(want)
    assert got["prefix_hits"] == want["prefix_hits"] == 0
    assert got["prefix_hit_rate"] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_index_matches_reference(seed):
    """Seeded random register / unregister / lookup sequences over a small
    alphabet (so prefixes collide): the same (slot, depth) every time."""
    rng = np.random.RandomState(seed)
    ours, theirs = PrefixIndex(), RefPrefixIndex()
    depth = {}
    for _ in range(300):
        op = rng.randint(3)
        slot = int(rng.randint(6))
        if op == 0:
            toks = rng.randint(0, 3, size=rng.randint(1, 7)).tolist()
            ours.register(slot, toks)
            theirs.register(slot, toks)
            depth[slot] = int(rng.randint(0, 8))
        elif op == 1:
            ours.unregister(slot)
            theirs.unregister(slot)
        else:
            toks = rng.randint(0, 3, size=rng.randint(0, 8)).tolist()
            exclude = (slot,) if rng.randint(2) else ()
            valid = lambda s: depth.get(s, 0)     # noqa: E731
            assert ours.lookup(toks, valid, exclude) == \
                theirs.lookup(toks, valid, exclude), toks
        assert ours._tokens == theirs._tokens


def test_prefix_index_unit_cases():
    """The reference's trie cases: the deepest match wins, ``valid_depth``
    caps a source, exclusion, pruning on unregister."""
    idx = PrefixIndex()
    idx.register(0, [5, 6, 7, 8])
    idx.register(1, [5, 6, 9])
    depths = {0: 4, 1: 3}
    assert idx.lookup([5, 6, 7, 8, 1], depths.get) == (0, 4)
    assert idx.lookup([5, 6, 9, 2], depths.get) == (1, 3)
    assert idx.lookup([5, 6, 1], depths.get)[1] == 2
    assert idx.lookup([9, 9], depths.get) == (None, 0)
    assert idx.lookup([5, 6, 7], {0: 1, 1: 0}.get) == (0, 1)
    assert idx.lookup([5, 6, 9], depths.get, exclude=(1,)) == (0, 2)
    idx.unregister(0)
    assert idx.lookup([5, 6, 7, 8], depths.get) == (1, 2)
    assert 7 not in idx._root[5][1][6][1]           # pruned


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix_fn", [_shared_mix, _fan_mix],
                         ids=["shared", "fan"])
def test_sharing_bitwise_to_no_sharing(qwen, mix_fn):
    """At one token an iteration sharing on is bitwise to sharing off: the
    same tokens per rid and the same first-token logits rows, in fewer
    iterations."""
    mix = mix_fn(qwen.model_cfg.vocab)
    runs = []
    for share in (True, False):
        eng = ServeEngine.from_session(qwen, max_slots=mix["width"],
                                       max_len=MAX_LEN, prefix_sharing=share)
        rows = _first_rows(eng)
        runs.append((_drive(eng, mix), rows))
    (on, on_rows), (off, off_rows) = runs
    assert on["prefix_hits"] == len(mix["late"])
    assert off["prefix_hits"] == 0
    assert _by_rid(on) == _by_rid(off)
    assert sorted(on_rows) == sorted(off_rows) == list(range(len(_by_rid(on))))
    for rid in on_rows:
        assert torch.equal(on_rows[rid], off_rows[rid]), rid
    assert on["iterations"] < off["iterations"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_share_prefix_copies_rows(qwen, dtype):
    """Rows [0, depth) of every leaf are bitwise copies of the source's;
    the destination's rows past depth and a third slot stay as they
    were."""
    pool = CachePool(qwen.model, qwen.state.params, 3, 8, dtype=dtype)
    s0, s1, s2 = pool.insert(), pool.insert(), pool.insert()
    for i, (leaf, bax) in enumerate(zip(pool.cache["blocks"].values(),
                                        pool.batch_axes)):
        for slot, sign in ((s0, 1.0), (s1, -1.0), (s2, 0.5)):
            row = leaf.select(bax, slot)
            row.copy_(sign * (torch.arange(row.numel(), dtype=torch.float32)
                              .reshape(row.shape) + 1 + i))
    before = {k: c.clone() for k, c in pool.cache["blocks"].items()}
    pool.prefix_index.register(s0, [1, 2, 3, 4, 5, 6])
    pool.positions[s0] = 5
    depth = pool.share_prefix(s1, [1, 2, 3, 4, 9])
    assert depth == 4 and pool.positions[s1] == 4
    assert pool.prefix_index._tokens[s1] == (1, 2, 3, 4, 9)
    for (k, c), bax, pax in zip(pool.cache["blocks"].items(),
                                pool.batch_axes, pool.pos_axes):
        assert c.dtype == dtype
        pax_r = pax - (1 if bax < pax else 0)
        src, dst = c.select(bax, s0), c.select(bax, s1)
        old = before[k].select(bax, s1)
        assert torch.equal(dst.narrow(pax_r, 0, 4), src.narrow(pax_r, 0, 4))
        assert torch.equal(dst.narrow(pax_r, 4, dst.shape[pax_r] - 4),
                           old.narrow(pax_r, 4, old.shape[pax_r] - 4))
        for slot in (s0, s2):
            assert torch.equal(c.select(bax, slot),
                               before[k].select(bax, slot))
    # the sources have written only 2 and 1 rows: only 2 can be shared
    pool.positions[s0], pool.positions[s1] = 2, 1
    assert pool.share_prefix(s2, [1, 2, 3, 7]) == 2
    pool.assert_consistent()


def test_pin_park_unpin(qwen):
    """A slot pinned as a copy source is parked by evict (unregistered,
    position 0) and freed when the last pin drops."""
    pool = CachePool(qwen.model, qwen.state.params, 2, 16)
    assert pool.supports_prefix_sharing
    s0 = pool.insert()
    pool.prefix_index.register(s0, [1, 2, 3])
    pool.positions[s0] = 3
    pool.pin(s0)
    pool.pin(s0)
    pool.evict(s0)                       # parked, NOT freed
    assert pool.n_free == 1 and s0 in pool._pending_free
    assert s0 not in pool.prefix_index._tokens and pool.positions[s0] == 0
    pool.assert_consistent()
    with pytest.raises(ValueError):
        pool.evict(s0)                   # double evict still rejected
    pool.unpin(s0)
    assert s0 in pool._pending_free      # one pin left
    pool.unpin(s0)                       # last pin drops -> freed
    assert pool.n_free == 2 and not pool._pending_free
    pool.assert_consistent()
    with pytest.raises(ValueError, match="unpinned more than pinned"):
        pool.unpin(s0)


def test_failed_admission_requeues_and_frees_slot(qwen, monkeypatch):
    """An exception during admission (here: the prefix copy) frees the
    claimed slot and puts the request back at the FRONT of the queue:
    nothing leaked, nothing dropped."""
    vocab = qwen.model_cfg.vocab
    engine = ServeEngine.from_session(qwen, max_slots=2, max_len=MAX_LEN)
    st = engine.submit(Request(prompt=_prompts(vocab, [4], 33)[0],
                               max_new_tokens=3))

    def boom(slot, tokens):
        raise RuntimeError("device copy failed")

    monkeypatch.setattr(engine.pool, "share_prefix", boom)
    with pytest.raises(RuntimeError, match="device copy failed"):
        engine.step()
    sch = engine.scheduler
    assert list(sch.queue) == [st]              # requeued, front of queue
    assert st.slot is None and st.status == "queued"
    assert st.pos == 0 and st.prefix_tokens == 0
    assert engine.pool.n_free == 2
    engine.pool.assert_consistent()
    monkeypatch.undo()
    out = engine.run()                          # and it still completes
    assert len(out["results"]) == 1
    assert out["results"][0]["finish_reason"] == "length"
