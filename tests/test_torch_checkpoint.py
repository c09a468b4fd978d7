"""Durable checkpoints of the port: the reference's on-disk format, its
corruption handling, the async writer, in-process resume, and the exchange
of checkpoints between the two packages.

Mirrors tests/test_resilience.py's checkpoint half and
tests/test_checkpoint.py's writer tests on the port.  Tolerances:
* in-process resume (fit 3 -> checkpoint -> restore -> fit 3 against fit 6)
  on the reduced qwen2-0.5b: BITWISE, params sha256 and ε ``float.hex``;
* a checkpoint the reference's ``save`` wrote after 2 steps, restored by the
  port and run one step further with the reference's noise, against the
  reference's own third step: params within 1e-5 of the largest parameter
  (the fit tolerance of test_torch_session.py), ε exact;
* the reference's ``load`` of a port checkpoint: every array bitwise.
"""
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load as ref_load
from repro.core import DPConfig as RefDPConfig
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.utils.params import FlatGradView as RefView
from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointCorruptError,
                                    gc, load, restore, save)
from repro_torch.core import DPConfig
from repro_torch.core import fused as fused_mod
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.launch import costmodel
from repro_torch.obs import MetricsRegistry
from repro_torch.resilience import chaos
from repro_torch.resilience.faults import (FaultInjected, FaultPlan,
                                           InjectedIOError, active)
from repro_torch.utils.params import flatten_tree

PARAMS = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
OPT = {"count": np.int32(3), "mom": np.ones(4, np.float32)}


# -- the on-disk format: corruption taxonomy ---------------------------------

def _newest_state(path):
    rec = json.load(open(os.path.join(path, load(path).manifest)))
    return os.path.join(path, rec["state"]), rec

@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: these tests run many small ops, which stall on
    thread barriers when several test workers share the machine's cores
    (the numbers compared do not depend on the thread count: every side
    of each comparison runs in this process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def test_corrupt_truncated_state_falls_back_then_raises(tmp_path):
    d = str(tmp_path / "ck")
    save(d, PARAMS, OPT, 1, {})
    save(d, {"w": PARAMS["w"] * 2}, OPT, 2, {})
    spath, _ = _newest_state(d)
    with open(spath, "r+b") as f:
        f.truncate(8)
    with pytest.warns(RuntimeWarning, match="skipped corrupt"):
        snap = load(d)
    assert snap.step == 1
    for name in os.listdir(d):
        if name.startswith("state-"):
            with open(os.path.join(d, name), "r+b") as f:
                f.truncate(8)
    with pytest.raises(CheckpointCorruptError,
                       match="last good manifest: none") as ei:
        load(d)
    assert ei.value.offending.startswith("state-")
    assert ei.value.fallback is None


def test_corrupt_bad_digest_names_offending_file(tmp_path):
    d = str(tmp_path / "ck")
    save(d, PARAMS, OPT, 5, {})
    spath, _ = _newest_state(d)
    data = open(spath, "rb").read()
    with open(spath, "wb") as f:
        f.write(data[:-4] + bytes(b ^ 0xFF for b in data[-4:]))
    with pytest.raises(CheckpointCorruptError, match="digest mismatch") as ei:
        load(d)
    assert os.path.basename(spath) in str(ei.value)
    assert ei.value.offending == os.path.basename(spath)


def test_corrupt_missing_member_and_missing_state(tmp_path):
    d = str(tmp_path / "ck")
    save(d, PARAMS, OPT, 5, {})
    spath, rec = _newest_state(d)
    np.savez(spath, **{"opt.count": np.int32(1)})
    rec["sha256"] = chaos.hashlib.sha256(open(spath, "rb").read()).hexdigest()
    manifest = sorted(n for n in os.listdir(d)
                      if n.startswith("manifest-"))[-1]
    json.dump(rec, open(os.path.join(d, manifest), "w"))
    with pytest.raises(CheckpointCorruptError, match="no params"):
        load(d)
    os.remove(spath)
    with pytest.raises(CheckpointCorruptError, match="is missing"):
        load(d)


def test_torn_window_regression(tmp_path):
    """State bytes durable, manifest not: the directory restores the
    PREVIOUS snapshot, and the next save commits over the junk blob."""
    d = str(tmp_path / "ck")
    save(d, PARAMS, OPT, 1, {"tag": "good"})
    plan = FaultPlan.single("ckpt/after_state_before_manifest",
                            action="raise")
    with active(plan), pytest.raises(FaultInjected):
        save(d, {"w": PARAMS["w"] * 9}, OPT, 2, {"tag": "torn"})
    snap = load(d)
    assert snap.step == 1 and snap.meta["tag"] == "good"
    np.testing.assert_array_equal(snap.params["w"], PARAMS["w"])
    save(d, {"w": PARAMS["w"] * 3}, OPT, 3, {}, keep=2)
    assert load(d).step == 3


def test_gc_keeps_last_k_and_referenced_blobs(tmp_path):
    d = str(tmp_path / "ck")
    for i in range(5):
        save(d, {"w": PARAMS["w"] * (i + 1)}, OPT, i + 1, {})
    deleted = gc(d, keep=2)
    names = sorted(os.listdir(d))
    assert len([n for n in names if n.startswith("manifest-")]) == 2
    assert len([n for n in names if n.startswith("state-")]) == 2
    assert load(d).step == 5 and len(deleted) == 6
    with pytest.raises(ValueError, match="keep must be"):
        gc(d, keep=0)


# -- the async writer ----------------------------------------------------------

@pytest.mark.parametrize("fails,retries", [(2, 2), (10, 2)],
                         ids=["recovers", "exhausted"])
def test_async_retry_and_counters(tmp_path, fails, retries):
    """Transient I/O failures at the write seam are retried with
    exponential backoff; exhausting the retries surfaces on wait(), counts
    a failure and commits no manifest."""
    sleeps, obs = [], MetricsRegistry("events")
    ac = AsyncCheckpointer(retries=retries, backoff=0.05,
                           sleep=sleeps.append, obs=obs)
    d = str(tmp_path / "ck")
    tensors = {"w": torch.from_numpy(PARAMS["w"].copy())}
    with active(FaultPlan.single("ckpt/io_write", action="io",
                                 count=fails)):
        ac.save(d, tensors, None, 1, {})
        # the copy is taken before save returns: the state may change now
        tensors["w"].add_(100.0)
        if fails <= retries:
            ac.wait()
        else:
            with pytest.raises(InjectedIOError):
                ac.wait()
    assert sleeps == [0.05, 0.1]
    assert obs.counters["ckpt/retries"] == 2
    if fails <= retries:
        params, _, step, _ = restore(d)
        assert step == 1
        np.testing.assert_array_equal(params["w"], PARAMS["w"])
        assert obs.counters["ckpt/saves"] == 1
        rec, = ac.records
        assert rec["bytes"] == PARAMS["w"].nbytes and rec["step"] == 1
        assert obs.hists["ckpt/d2h"].count == 1
    else:
        assert obs.counters["ckpt/failures"] == 1
        assert not any(n.startswith("manifest-") for n in os.listdir(d))


# -- sessions: resume, guard, tile -------------------------------------------

def _session(engine, steps=6, **kw):
    tc = TrainConfig(steps=steps, n_data=32, q=0.25, seq_len=8,
                     physical_batch=4, seed=0, lr=0.1, optimizer="sgd",
                     momentum=0.9, log_every=10 ** 9, **kw)
    dp = DPConfig(engine=engine, clip_norm=0.1, noise_multiplier=0.8)
    return PrivacySession.from_config("qwen2-0.5b", dp, tc,
                                      device="cpu"), dp, tc


@pytest.mark.parametrize("engine", ["masked_pe", "nonprivate",
                                    "masked_fused_stream"])
def test_resume_parity_bitwise(tmp_path, engine):
    """fit(6) == fit(3) -> checkpoint -> restore -> fit(3): params digest
    and ε (``float.hex``) identical."""
    base, _, _ = _session(engine)
    base.fit(steps=6)
    want = chaos.outcome(base)
    d = str(tmp_path / "ck")
    s1, dp, tc = _session(engine)
    s1.fit(steps=3, ckpt=d, ckpt_every=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # an opt-state fallback = failure
        s2 = PrivacySession.restore(d, "qwen2-0.5b", dp, tc, device="cpu")
    assert s2.state.step == 3 and s2.state.rng == s1.state.rng
    s2.fit(steps=3)
    got = chaos.outcome(s2)
    assert got["step"] == want["step"] == 6
    assert got["params_sha256"] == want["params_sha256"]
    assert got["eps_hex"] == want["eps_hex"]


def test_restore_mismatched_optimizer_warns(tmp_path):
    import dataclasses
    d = str(tmp_path / "ck")
    s1, dp, tc = _session("nonprivate", steps=2)
    s1.fit(steps=2, ckpt=d)
    tc_adam = dataclasses.replace(tc, optimizer="adamw")
    with pytest.warns(RuntimeWarning, match="NOT be bitwise"):
        s2 = PrivacySession.restore(d, "qwen2-0.5b", dp, tc_adam,
                                    device="cpu")
    assert s2.state.step == 2


def test_fit_guard_accounts_for_restored_steps(tmp_path):
    tc = TrainConfig(steps=4, n_data=32, q=0.25, seq_len=8, physical_batch=4,
                     seed=0, target_eps=8.0, log_every=10 ** 9)
    dp = DPConfig(engine="masked_pe", clip_norm=0.1)
    d = str(tmp_path / "ck")
    s1 = PrivacySession.from_config("qwen2-0.5b", dp, tc, device="cpu")
    s1.fit(steps=2, ckpt=d)
    s2 = PrivacySession.restore(d, "qwen2-0.5b", dp, tc, device="cpu")
    with pytest.raises(ValueError, match="calibrated"):
        s2.fit(steps=3)                     # 2 + 3 > 4
    s2.fit(steps=2)


def test_stream_tile_sized_once_and_restored(tmp_path, monkeypatch):
    """The streaming tile is sized at the session's first accumulate and
    kept: a free memory that changes between calls does not change the
    width the engine folds at; the checkpoint carries the tile and a
    restored session folds at it whatever its own free memory says."""
    view_params = _session("masked_fused_stream")[0]
    n = sum(p.numel() for p in view_params.state.params.values())
    per_example = costmodel.STREAM_PE_SLABS * 4 * n
    fixed = costmodel.STREAM_FIXED_F32_BUFFERS * 4 * n
    budgets = iter([fixed + 2 * per_example] + [fixed + 4 * per_example]
                   * 100)
    for mod in (costmodel, fused_mod):
        monkeypatch.setattr(mod, "free_memory_bytes",
                            lambda device: next(budgets))
    widths = []
    inner = fused_mod.flat_clip_accum

    def spy(acc, tile, *a, **kw):
        widths.append(int(tile.shape[0]))
        return inner(acc, tile, *a, **kw)

    monkeypatch.setattr(fused_mod, "flat_clip_accum", spy)
    d = str(tmp_path / "ck")
    s1, dp, tc = _session("masked_fused_stream", steps=4)
    s1.fit(steps=2, ckpt=d)
    assert set(widths) == {2} and s1.describe()["stream_tile"] == 2
    widths.clear()
    s2 = PrivacySession.restore(d, "qwen2-0.5b", dp, tc, device="cpu")
    assert s2.restored_meta["stream_tile"] == 2
    s2.fit(steps=2)
    assert set(widths) == {2}


def test_fit_midloop_crash_leaves_checkpoint_durable(tmp_path):
    s, _, tc = _session("nonprivate", steps=4)
    from repro_torch.data import dataset_for_config
    inner = dataset_for_config(s.model_cfg, tc.n_data, tc.seq_len, seed=0)

    class DyingDataset:
        n = tc.n_data
        calls = 0

        def fetch(self, ix):
            DyingDataset.calls += 1
            if DyingDataset.calls > 6:
                raise RuntimeError("storage went away")
            return inner.fetch(ix)

    path = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="storage went away"):
        s.fit(DyingDataset(), ckpt=path, ckpt_every=1)
    assert not s._ckpt_writer.in_flight
    params, _, step, meta = restore(path)
    assert step >= 1 and meta["arch"].startswith("qwen2-0.5b")
    assert set(params) == set(s.state.params)


# -- exchange with the reference ---------------------------------------------

TRAIN = dict(steps=3, n_data=32, physical_batch=4, q=0.25, target_eps=8.0,
             lr=0.5, seed=0)


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """The reference saves after 2 steps; the port restores it and takes
    step 3 with the reference's noise; the reference takes its own step 3
    from the same checkpoint."""
    d = str(tmp_path / "ck")
    ref = RefSession.from_config(
        "vit-base", RefDPConfig(engine="masked_pe", clip_norm=1.0),
        RefTrainConfig(**TRAIN))
    ref.fit(steps=2, ckpt=d)
    _, nkey = jax.random.split(ref.state.rng)
    z = np.array(RefView.for_tree(ref.state.params).noise(nkey))
    ref.fit(steps=1)
    port = PrivacySession.restore(
        d, "vit-base", DPConfig(engine="masked_pe", clip_norm=1.0),
        TrainConfig(**TRAIN), device="cpu")
    assert port.state.step == 2 and port.state.opt_state["count"] == 2
    out = port.fit(steps=1, noise=lambda k: torch.from_numpy(z))
    assert float(out["final_eps"]).hex() == \
        float(ref.privacy_spent()[0]).hex()
    want = flatten_tree(jax.tree.map(np.asarray, ref.state.params))
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(port.state.params[name].numpy(), w,
                                   rtol=0, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_reference_reads_port_checkpoint(tmp_path, optimizer):
    """The reference's load returns the port's arrays bit for bit, and its
    PrivacySession.restore takes the port's optimizer state without a
    layout warning (flat momentum; AdamW's moments per leaf)."""
    d = str(tmp_path / "ck")
    train = dict(TRAIN, steps=2, optimizer=optimizer)
    port = PrivacySession.from_config(
        "vit-base", DPConfig(engine="masked_pe", clip_norm=1.0),
        TrainConfig(**train), device="cpu")
    port.fit(ckpt=d)
    snap = ref_load(d)
    got = flatten_tree(snap.params)
    assert set(got) == set(port.state.params)
    for name, p in port.state.params.items():
        assert np.array_equal(got[name], p.numpy()), name
    assert snap.step == 2 and int(snap.opt_flat["count"]) == 2
    assert snap.meta["accountant"] == port.accountant.state_dict()
    np.testing.assert_array_equal(snap.extra["rng"],
                                  np.array(port.state.rng, np.uint32))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        ref = RefSession.restore(d, "vit-base",
                                 RefDPConfig(engine="masked_pe",
                                             clip_norm=1.0),
                                 RefTrainConfig(**train))
    key = "mom" if optimizer == "sgd" else "mu"
    want = port.state.opt_state[key].numpy()
    tree = ref.state.opt_state[key]
    flat = np.asarray(RefView.for_tree(ref.state.params).flatten(tree)
                      if isinstance(tree, dict) else tree)
    assert np.array_equal(flat, want)


@pytest.mark.parametrize("engine", ["masked_fused_stream", "masked_ghost"])
def test_session_is_freed_without_the_cycle_collector(tmp_path, engine):
    """A session (after a checkpointed fit) holds no reference cycle: the
    card's memory comes back at ``del``, not at the next collection, which
    the 630M-parameter fits on the card depend on."""
    import gc
    import weakref
    s = PrivacySession.from_config(
        "vit-base", DPConfig(engine=engine, clip_norm=1.0),
        TrainConfig(steps=1, n_data=16, physical_batch=4, q=0.25,
                    target_eps=8.0), device="cpu")
    s.fit(ckpt=str(tmp_path / "ck"), ckpt_every=1)
    ref = weakref.ref(s)
    gc.disable()
    try:
        del s
        assert ref() is None
    finally:
        gc.enable()
