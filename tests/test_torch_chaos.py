"""The port's chaos harness on the CPU: real subprocess training runs of
the reduced qwen2-0.5b killed at registered fault points and resumed in a
fresh process, held BITWISE to the uninterrupted run (params sha256 and ε
``float.hex``), as tests/test_resilience.py holds the reference.  The
smoke case runs in tier-1; the full training-point matrix is
``slow``-marked, as the reference's is.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.resilience import chaos
from repro_torch.resilience.faults import ENV_VAR

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU_CASE = dict(device="cpu", timeout=280)

@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread in every subprocess (``OMP_NUM_THREADS``, which
    they inherit): the runs are small, and stall on thread barriers when
    several test workers share the machine's cores.  Every run of a case
    gets the same setting, so the bitwise comparison is unaffected."""
    prev = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if prev is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = prev



def test_chaos_smoke_subprocess(tmp_path):
    """One real kill on the CPU: the smoke case crashes a subprocess run in
    the torn window via os._exit and the resumed run is bitwise identical
    to the uninterrupted one."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop(ENV_VAR, None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.resilience.chaos", "smoke",
         "--device", "cpu", "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=580, env=env)
    assert proc.returncode == 0, f"chaos smoke failed:\n{proc.stdout}\n" \
                                 f"{proc.stderr}"
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["match"] and rec["fired"]
    assert rec["crash_returncode"] == chaos.DEFAULT_EXIT_CODE


@pytest.fixture(scope="module")
def port_chaos_baseline(tmp_path_factory):
    d = tmp_path_factory.mktemp("port-chaos-baseline")
    out = os.path.join(str(d), "baseline.json")
    proc = chaos._spawn(chaos._run_args(
        ckpt=os.path.join(str(d), "ckpt"), out=out, arch="qwen2-0.5b",
        engine="masked_pe", steps=6, ckpt_every=2, seed=0, n_data=32,
        q=0.25, seq_len=8, physical_batch=4, sigma=0.8, device="cpu"))
    assert proc.returncode == 0, proc.stderr
    return out


@pytest.mark.slow
@pytest.mark.parametrize("point", chaos.TRAIN_POINTS)
def test_chaos_full_matrix(tmp_path, point, port_chaos_baseline):
    rec = chaos.run_case(point, workdir=str(tmp_path),
                         baseline_out=port_chaos_baseline, **CPU_CASE)
    assert rec["fired"], rec
    assert rec["match"], rec
