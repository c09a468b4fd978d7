"""Fault injection and the chaos harness of the port, mirroring
tests/test_resilience.py: fault plans (parsing, the at/count window, the
port's own environment variable), the registered points against the
port's call sites, the seeded under-count mutation caught by the bitwise
comparison, and the params digest against the reference's.  The real
subprocess kills are in test_torch_chaos.py.
"""
import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.resilience import chaos as ref_chaos
from repro.resilience import faults as ref_faults
from repro_torch.core import DPConfig
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.resilience import chaos, faults
from repro_torch.resilience.faults import (ENV_VAR, KNOWN_POINTS,
                                           FaultInjected, FaultPlan,
                                           FaultSpec, active, fault_point)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

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



def test_fault_spec_parse_and_validation():
    s = FaultSpec.parse("fit/step_end:raise:at=3:count=2")
    assert (s.point, s.action, s.at, s.count) == ("fit/step_end", "raise",
                                                  3, 2)
    assert FaultSpec.parse("ckpt/io_write").action == "exit"
    with pytest.raises(ValueError, match="unknown fault point"):
        FaultSpec(point="nope/nothing")
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultSpec(point="fit/step_end", action="explode")
    with pytest.raises(ValueError, match="at/count"):
        FaultSpec(point="fit/step_end", at=0)


def test_fault_plan_fires_on_at_window_only():
    plan = FaultPlan.single("fit/step_end", action="raise", at=3, count=2)
    with active(plan):
        fault_point("fit/step_end")
        fault_point("fit/step_end")
        fault_point("ckpt/before_state")
        for _ in range(2):
            with pytest.raises(FaultInjected):
                fault_point("fit/step_end")
        fault_point("fit/step_end")
    assert plan.hits["fit/step_end"] == 5
    assert plan.fired == ["fit/step_end", "fit/step_end"]


def test_fault_plan_env_is_the_ports_own(monkeypatch):
    """REPRO_TORCH_FAULT_PLAN arms the port; the reference's variable does
    not, so a reference test's plan never arms the port in the same
    worker."""
    assert ENV_VAR == "REPRO_TORCH_FAULT_PLAN" != ref_faults.ENV_VAR
    assert KNOWN_POINTS == ref_faults.KNOWN_POINTS
    plan = FaultPlan.single("ckpt/io_write", action="io", count=3)
    prev = faults.active_plan()
    try:
        monkeypatch.setenv(ref_faults.ENV_VAR, plan.to_json())
        monkeypatch.delenv(ENV_VAR, raising=False)
        faults.activate(None)
        faults._install_from_env()
        assert faults.active_plan() is None
        monkeypatch.setenv(ENV_VAR, plan.to_json())
        faults._install_from_env()
        got = faults.active_plan()
        assert got is not None and got.specs == plan.specs
    finally:
        faults.activate(prev)


def test_known_points_match_port_call_sites():
    """Every training point has a fault_point() call site in the port and
    every call site names a registered point."""
    called = set()
    for root, _dirs, names in os.walk(os.path.join(SRC, "repro_torch")):
        for name in names:
            if name.endswith(".py") and name != "faults.py":
                with open(os.path.join(root, name)) as f:
                    called.update(re.findall(r'fault_point\("([^"]+)"\)',
                                             f.read()))
    assert called == set(chaos.TRAIN_POINTS) <= set(KNOWN_POINTS)
    assert ({k: dataclasses.asdict(v) for k, v in chaos.DEFAULT_ARMING.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_chaos.DEFAULT_ARMING.items()})
    assert chaos.TRAIN_POINTS == ref_chaos.TRAIN_POINTS


def test_digest_matches_the_reference_digest():
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": np.ones(3, np.float32)}
    flat = {"a.w": torch.from_numpy(tree["a"]["w"]),
            "b": torch.from_numpy(tree["b"])}
    assert chaos.digest_params(flat) == ref_chaos.digest_params(
        jax.tree.map(np.asarray, tree))


def test_under_count_mutation_is_caught(tmp_path):
    """A resume that replays the sampler stream from step 0 must NOT pass
    the bitwise comparison."""
    def session():
        tc = TrainConfig(steps=6, n_data=32, q=0.25, seq_len=8,
                         physical_batch=4, seed=0, lr=0.1, momentum=0.9,
                         log_every=10 ** 9)
        dp = DPConfig(engine="masked_pe", clip_norm=0.1,
                      noise_multiplier=0.8)
        return (PrivacySession.from_config("qwen2-0.5b", dp, tc,
                                           device="cpu"), dp, tc)
    base, _, _ = session()
    base.fit(steps=6)
    want = chaos.outcome(base)
    d = str(tmp_path / "ck")
    s1, dp, tc = session()
    s1.fit(steps=3, ckpt=d, ckpt_every=2)
    s2 = PrivacySession.restore(d, "qwen2-0.5b", dp, tc, device="cpu")
    s2.state.step = 0                     # forget the restored position
    s2.fit(steps=3)
    assert chaos.outcome(s2)["params_sha256"] != want["params_sha256"]
