"""The port's telemetry, mirroring tests/test_obs.py: ``off`` adds ZERO
sync points (pinned with a counting ``sync=`` injection and, end to end,
with the CUDA synchronisation entry points patched under a default
``fit()``), ``sampled`` waits on each span's watched value on sampled ticks
only, deterministic-clock span nesting, histogram percentiles, the JSONL
schema, ``fit()``'s spans and gauges, the checkpoint-wait histogram and
counter, and the CLI flags.
"""
import argparse
import time

import pytest
import torch

from repro_torch.core import DPConfig
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.obs import (Histogram, JsonlExporter, MetricsRegistry,
                             ObsConfig, SCHEMA_VERSION, add_cli_args,
                             config_from_args, default_sync, read_jsonl)

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



class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


class ListExporter:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def close(self):
        pass


def _session(obs=None, **tc_kw):
    dp = DPConfig(clip_norm=0.1, noise_multiplier=0.7, engine="masked_pe")
    tc = TrainConfig(steps=2, n_data=16, q=0.25, seq_len=8, physical_batch=4,
                     seed=0, lr=0.1, momentum=0.0, **tc_kw)
    return PrivacySession.from_config("qwen2-0.5b", dp, tc, device="cpu",
                                      obs=obs)


def test_span_nesting_with_injected_clock():
    exp = ListExporter()
    reg = MetricsRegistry("events", clock=FakeClock(), exporter=exp)
    reg.tick()
    with reg.span("outer"):
        with reg.span("inner"):
            pass
    assert reg.hists["inner"].total == pytest.approx(1.0)
    assert reg.hists["outer"].total == pytest.approx(3.0)
    spans = [r for r in exp.records if r["kind"] == "span"]
    assert [s["name"] for s in spans] == ["inner", "outer"]
    assert spans[0]["parent"] == "outer" and spans[1]["parent"] is None
    assert all(s["tick"] == 1 and not s["synced"] for s in spans)


def test_histogram_percentile_math():
    h = Histogram()
    for v in range(1, 101):
        h.observe(float(v))
    assert h.count == 100 and h.mean == pytest.approx(50.5)
    assert h.percentile(0.5) == 50.0 and h.percentile(0.95) == 95.0
    small = Histogram(cap=4)
    for v in (1.0, 2.0, 3.0, 4.0, 100.0):
        small.observe(v)
    assert small.count == 5 and small.total == pytest.approx(110.0)


def test_jsonl_schema_roundtrip(tmp_path):
    p = str(tmp_path / "log.jsonl")
    reg = MetricsRegistry("events", clock=FakeClock(),
                          exporter=JsonlExporter(p))
    reg.tick()
    with reg.span("phase"):
        pass
    reg.gauge("g", 2.5)
    reg.event("request", rid=7)
    reg.close()
    assert [r["kind"] for r in read_jsonl(p)] == ["span", "gauge", "event",
                                                  "stats"]
    assert read_jsonl(p, kind="stats")[0]["gauges"]["g"] == 2.5
    lines = open(p).read().splitlines()
    bad = tmp_path / "bad.jsonl"
    bad.write_text(lines[0].replace(f'"version": {SCHEMA_VERSION}',
                                    f'"version": {SCHEMA_VERSION + 1}')
                   + "\n" + "\n".join(lines[1:]))
    with pytest.raises(ValueError, match="schema version"):
        read_jsonl(str(bad))


def test_off_mode_zero_syncs_sampled_mode_syncs():
    def boom(x):
        raise AssertionError("sync point in off mode")

    off = MetricsRegistry("off", sync=boom)
    off.tick()
    with off.span("phase") as sp:
        sp.watch(object())
    off.inc("c")
    off.gauge("g", 1.0)
    assert not off.counters and not off.gauges and not off.hists
    calls = []
    reg = MetricsRegistry("sampled", sample_every=2, sync=calls.append,
                          clock=FakeClock())
    for _ in range(4):
        reg.tick()
        with reg.span("phase") as sp:
            sp.watch("v")
    assert calls == ["v", "v"] and reg.hists["phase"].count == 2


@pytest.mark.parametrize("mode", ["off", "sampled"])
def test_fit_sync_count_by_mode(mode, monkeypatch):
    """A default fit() (off) makes no sync call at all, through the
    registry or CUDA's entry points; sampled mode syncs the accumulate and
    update spans of each step."""
    cuda_calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: cuda_calls.append(a))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        lambda self: cuda_calls.append(self))
    calls = []
    reg = MetricsRegistry(mode, sync=calls.append)
    out = _session(obs=reg if mode != "off" else None).fit()
    assert len(out["history"]) == 2 and not cuda_calls
    assert len(calls) == 0 if mode == "off" else len(calls) == 4


def test_default_sync_leaves_cpu_tensors_alone(monkeypatch):
    hit = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: hit.append(a))
    default_sync({"a": torch.zeros(3), "b": [torch.ones(2)]})
    assert not hit


def test_fit_emits_spans_and_dp_gauges(tmp_path):
    p = str(tmp_path / "train.jsonl")
    session = _session(obs=ObsConfig(mode="sampled", jsonl=p))
    session.fit()
    session.obs.close()
    span_names = {r["name"] for r in read_jsonl(p, kind="span")}
    assert {"fit/accumulate", "fit/update", "fit/account",
            "fit/eval"} <= span_names
    assert all(r["synced"] for r in read_jsonl(p, kind="span")
               if r["name"] in ("fit/accumulate", "fit/update"))
    gauges = {r["name"] for r in read_jsonl(p, kind="gauge")}
    assert {"dp/eps", "dp/clip_fraction", "dp/mean_grad_norm",
            "dp/max_grad_norm"} <= gauges
    eps = [r["value"] for r in read_jsonl(p, kind="gauge")
           if r["name"] == "dp/eps"]
    assert len(eps) == 2 and eps == sorted(eps)
    assert eps[-1] == pytest.approx(session.privacy_spent()[0])
    stats = read_jsonl(p, kind="stats")[0]
    assert stats["counters"]["fit/steps"] == 2


def test_fit_surfaces_ckpt_wait(tmp_path, monkeypatch):
    """checkpoint_async stalls are timed, counted and warned about when
    they exceed one mean step time; the writer's copy and commit times are
    observed."""
    session = _session(obs=ObsConfig(mode="events"))
    fake_t = [0.0]

    def fake_perf_counter():
        fake_t[0] += 100.0
        return fake_t[0]

    monkeypatch.setattr(time, "perf_counter", fake_perf_counter)
    with pytest.warns(RuntimeWarning, match="checkpoint wait"):
        session.fit(ckpt=str(tmp_path / "ck"), ckpt_every=1)
    obs = session.obs
    assert obs.hists["fit/ckpt_wait"].count == 2
    assert obs.counters["fit/ckpt_wait_exceeded"] == 2
    assert obs.counters["ckpt/saves"] == 2
    assert obs.hists["ckpt/d2h"].count == obs.hists["ckpt/commit"].count == 2


def test_obs_cli_flags_roundtrip(tmp_path):
    ap = argparse.ArgumentParser()
    add_cli_args(ap)
    args = ap.parse_args(["--metrics", "sampled", "--sample-every", "3",
                          "--metrics-jsonl", str(tmp_path / "m.jsonl"),
                          "--metrics-every", "10"])
    reg = config_from_args(args).build()
    assert (reg.mode, reg.sample_every, reg.snapshot_every) == ("sampled",
                                                                3, 10)
    assert reg.exporter is not None
    reg.close()
    reg2 = ObsConfig(profile_dir=str(tmp_path / "prof")).build()
    assert reg2.mode == "events" and reg2.annotate


def test_train_cli_metrics_profile_and_ckpt(tmp_path, capsys):
    """The training CLI with the reference's --optimizer, --ckpt and obs
    flags: a torch.profiler trace, a JSONL log and a durable checkpoint."""
    from repro_torch.checkpoint import restore
    from repro_torch.launch import train
    log = str(tmp_path / "m.jsonl")
    out = train.main(["--smoke", "--device", "cpu", "--steps", "1",
                      "--n-data", "16", "--physical", "4", "--q", "0.25",
                      "--optimizer", "adamw", "--ckpt",
                      str(tmp_path / "ck"), "--metrics", "events",
                      "--metrics-jsonl", log, "--profile-dir",
                      str(tmp_path / "prof")])
    assert out["history"] and (tmp_path / "prof" / "trace.json").exists()
    assert read_jsonl(log, kind="stats")[0]["counters"]["fit/steps"] == 1
    _, opt, step, meta = restore(str(tmp_path / "ck"))
    assert step == 1 and meta["optimizer"] == "adamw"
    assert any(k.startswith("mu.") for k in opt)
    assert "metrics snapshot" in capsys.readouterr().err
