"""The whole slice: ``PrivacySession.fit()`` of the reduced ViT in the port
against the reference's ``fit()``, with the reference's initial weights
(``params_from_numpy``) and the reference's noise fed in as the update's
operand (drawn as its ``build_update_fn`` draws it: ``jax.random.split`` of
the state key, then ``FlatGradView.noise``).

Tolerances: sampler draws (logical batch sizes), σ and ε are EXACT
(``float.hex``); parameters and momentum after 2 steps within 1e-5 of the
largest parameter (per-example grads differ at f32 rounding, see
test_torch_vit.py; the update adds 1 ULP per contracted op, see
test_torch_kernels.py); logged losses within 1e-3.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import DPConfig as RefDPConfig
from repro.core.session import PrivacySession as RefSession
from repro.core.session import TrainConfig as RefTrainConfig
from repro.utils.params import FlatGradView as RefView
from repro_torch.core import DPConfig
from repro_torch.core.session import PrivacySession, TrainConfig
from repro_torch.utils.params import flatten_tree, params_from_numpy

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TRAIN = dict(steps=2, n_data=32, physical_batch=4, q=0.25, target_eps=8.0,
             lr=0.5, seed=0)


def _reference_noise(ref, steps):
    view = RefView.for_tree(ref.state.params)
    key, out = ref.state.rng, []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.asarray(view.noise(nkey)))
    return out


@pytest.mark.parametrize("engine", ["masked_pe", "masked_fused_stream",
                                    "masked_fused", "masked_ghost",
                                    "masked_bk"])
def test_fit_matches_reference(engine):
    ref = RefSession.from_config(
        "vit-base", RefDPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        RefTrainConfig(**TRAIN))
    p0 = jax.tree.map(np.asarray, ref.state.params)
    noise = _reference_noise(ref, TRAIN["steps"])
    ref_out = ref.fit()

    port = PrivacySession.from_config(
        "vit-base", DPConfig(engine=engine, clip_norm=1.0, stream_tile=4),
        TrainConfig(**TRAIN), device="cpu",
        params=params_from_numpy(p0, "cpu"))
    out = port.fit(noise=lambda k: torch.tensor(noise[k]))

    assert out["sigma"].hex() == ref_out["sigma"].hex()
    assert float(out["final_eps"]).hex() == float(ref_out["final_eps"]).hex()
    assert port.dp.expected_batch_size == ref.dp.expected_batch_size
    for got, want in zip(out["history"], ref_out["history"]):
        assert got["logical_batch"] == want["logical_batch"]
        assert got["eps"] == want["eps"]
        assert got["loss"] == pytest.approx(want["loss"], abs=1e-3)
    want = flatten_tree(jax.tree.map(np.asarray, ref.state.params))
    scale = max(float(np.abs(v).max()) for v in want.values())
    moved = 0.0
    for name, w in want.items():
        got = port.state.params[name].numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
        moved = max(moved, float(np.abs(w - np.asarray(
            flatten_tree(p0)[name])).max()))
    assert moved > 1e-3           # the steps really changed the weights
    np.testing.assert_allclose(port.state.opt_state["mom"].numpy(),
                               np.asarray(ref.state.opt_state["mom"]),
                               rtol=0, atol=1e-5 * scale)
    assert port.state.step == ref_out["history"][-1]["step"]


def _tiny(engine="masked_fused_stream"):
    return PrivacySession.from_config(
        "vit-base", DPConfig(engine=engine, clip_norm=1.0),
        TrainConfig(steps=2, n_data=16, physical_batch=4, q=0.25,
                    target_eps=8.0 if engine != "nonprivate" else None),
        device="cpu")


def test_rerun_is_bit_identical_and_noise_follows_the_seed():
    a, b = _tiny(), _tiny()
    a.fit()
    b.fit()
    for name, p in a.state.params.items():
        assert torch.equal(p, b.state.params[name]), name
    # same weights and data, the other noise key: other noise
    c = _tiny()
    c.state.rng = (0, 99)
    c.fit()
    assert any(not torch.equal(p, c.state.params[n])
               for n, p in a.state.params.items())


def test_nonprivate_fit_charges_no_privacy():
    s = _tiny("nonprivate")
    out = s.fit()
    assert out["final_eps"] == 0.0 and out["sigma"] == 0.0
    assert len(out["history"]) == 2


def test_fit_refuses_more_steps_than_calibrated():
    with pytest.raises(ValueError, match="calibrated"):
        _tiny().fit(steps=3)


@pytest.mark.parametrize("engine", ["masked_fused", "masked_ghost",
                                    "masked_bk"])
def test_cli_trains_with_the_new_engines(engine, capsys):
    from repro_torch.launch import train
    out = train.main(["--smoke", "--device", "cpu", "--steps", "1",
                      "--n-data", "16", "--physical", "4", "--q", "0.25",
                      "--engine", engine, "--describe"])
    assert out["history"] and out["final_eps"] > 0
    described = json.loads(capsys.readouterr().out.splitlines()[0])
    assert described["engine"] == engine
    assert described["engine_traits"] == {
        "materializes_pe": engine == "masked_fused",
        "record_based": engine != "masked_fused", "streaming": False}


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card the defaults raise; nothing falls back to the CPU."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrivacySession.from_config("vit-base")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])


NO_JAX = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "repro"):
    sys.modules[blocked] = None          # any import of them now fails
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
from repro_torch.launch import train
out = train.main(["--smoke", "--device", "cpu", "--steps", "1",
                  "--n-data", "16", "--physical", "4", "--q", "0.25"])
assert out["history"], out
loaded = sorted(k for k in sys.modules if sys.modules[k] is not None
                and k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not loaded, loaded
print("NOJAX-OK", len(mods))
"""


def test_port_imports_and_trains_without_jax():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", NO_JAX], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NOJAX-OK" in out.stdout
