"""The memory probe's pieces that run off the card: the replay of the
allocator's trace, and the ``autograd`` route's gradient against
``nonprivate``'s ``torch.func.grad`` (the same sum of per-example losses:
within 1e-6 of the largest entry in f32, two backward orders of one
graph)."""
import numpy as np
import pytest
import torch

from repro_torch.core import DPConfig
from repro_torch.core.engine import build_accumulate_fn
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.launch import memprobe


def _ev(action, addr, size, where=None):
    frames = ([{"filename": "torch/nn/functional.py", "line": 1,
                "name": "f"},
               {"filename": f"src/repro_torch/{where}", "line": 7,
                "name": "g"}] if where else [])
    return {"action": action, "addr": addr, "size": size, "frames": frames}


def test_live_at_peak_groups_the_blocks_alive_at_the_peak():
    trace = [_ev("alloc", 1, 100, "models/common.py"),
             _ev("alloc", 2, 50, "core/engine.py"),
             _ev("free_requested", 2, 50),
             _ev("free_completed", 2, 50),
             _ev("alloc", 3, 300),
             _ev("alloc", 4, 20, "models/common.py"),   # the peak: 420
             _ev("free_requested", 3, 300),
             _ev("alloc", 5, 250, "core/engine.py")]    # 370 < 420
    got = memprobe.live_at_peak(trace)
    assert got["peak_bytes"] == 420 and got["live_blocks"] == 3
    assert got["by_frame"] == [["?", 300, 1],
                               ["common.py:7:g", 120, 2]]


def test_main_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        memprobe.main(["--device", "cpu"])


def test_autograd_route_matches_func_grad():
    session = PrivacySession.from_config(
        "qwen2-0.5b", DPConfig(engine="masked_pe"),
        TrainConfig(steps=1, n_data=8, q=0.5, physical_batch=4, seq_len=16,
                    smoke=True, momentum=0.0), device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, session.model_cfg.vocab,
                                         (4, 17)).astype(np.int64))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0])
    state = session.state
    build_accumulate_fn(session.loss_fn, DPConfig(engine="nonprivate"))(
        state, batch, mask)
    want = state.grad_acc.clone()
    state.grad_acc.zero_()
    memprobe._autograd_accumulate(session.loss_fn)(state, batch, mask)
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(state.grad_acc, want, rtol=0,
                               atol=1e-6 * scale)
