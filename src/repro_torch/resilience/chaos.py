"""Chaos harness of the port: kill real training subprocesses, resume,
compare bitwise — the reference package's ``resilience/chaos.py``.

The contract is the resilience invariant: for EVERY registered training
crash point (:data:`TRAIN_POINTS`), killing a checkpointing training run at
that point and resuming in a fresh process must reproduce the
uninterrupted run's final parameters **bitwise** (sha256 over the params in
path order) and its spent ε **bit for bit** (``float.hex()``).  Each case
runs three subprocesses:

  1. *baseline*  — the uninterrupted run (checkpointing on, same code path),
  2. *crash*     — the same run armed via ``REPRO_TORCH_FAULT_PLAN``;
     ``exit``-action faults die through ``os._exit`` (no cleanup),
  3. *resume*    — ``PrivacySession.restore`` in a brand-new process,
     finishing the remaining ``total - restored_step`` steps (a fresh run
     when nothing durable existed yet: nothing survived the crash either).

CLI::

    python -m repro_torch.resilience.chaos run   --ckpt DIR --out FILE [...]
    python -m repro_torch.resilience.chaos smoke --device cpu  # one case
    python -m repro_torch.resilience.chaos suite --device cpu  # every point

``--device`` defaults to ``cuda``; ``--arch vit-base --full --engine
masked_fused_stream`` runs full-width ViT-Base.  Subprocesses inherit the
parent's environment plus the port's ``src`` on ``PYTHONPATH``; the only
other variable is the fault plan JSON.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

# DEFAULT_EXIT_CODE is re-exported: harness callers assert on it
from .faults import (DEFAULT_EXIT_CODE, ENV_VAR,  # noqa: F401
                     KNOWN_POINTS, FaultSpec)

# The training-side points the chaos matrix sweeps (the port has no
# serving yet, so its serve/* point has no call site).
TRAIN_POINTS: List[str] = [p for p in sorted(KNOWN_POINTS)
                           if not p.startswith("serve/")]

# Per-point arming that makes each crash land mid-run (not trivially at the
# very start): checkpoint points fire on the SECOND save so one snapshot is
# already durable, fit points fire on step 3 of 6.
DEFAULT_ARMING: Dict[str, FaultSpec] = {
    "ckpt/before_state": FaultSpec("ckpt/before_state", at=2),
    "ckpt/io_write": FaultSpec("ckpt/io_write", at=2),
    "ckpt/after_state_before_manifest":
        FaultSpec("ckpt/after_state_before_manifest", at=2),
    "ckpt/after_manifest_before_gc":
        FaultSpec("ckpt/after_manifest_before_gc", at=2),
    "ckpt/mid_d2h": FaultSpec("ckpt/mid_d2h", at=2),
    "fit/after_account_before_ckpt":
        FaultSpec("fit/after_account_before_ckpt", at=3),
    "fit/step_end": FaultSpec("fit/step_end", at=3),
}


def digest_params(params) -> str:
    """sha256 over the parameters in path order (name, dtype, bytes): the
    reference's digest of the same values."""
    import numpy as np
    from ..utils.params import flatten_params
    h = hashlib.sha256()
    flat = flatten_params(params)
    for name in sorted(flat):
        v = flat[name]
        arr = np.ascontiguousarray(v.detach().cpu().numpy()
                                   if hasattr(v, "detach") else np.asarray(v))
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def outcome(session) -> dict:
    """The comparison record one run produces: step, params digest, exact ε."""
    eps, delta = session.privacy_spent()
    return {"step": int(session.state.step),
            "params_sha256": digest_params(session.state.params),
            "eps": float(eps),
            # float.hex() round-trips exactly — "close enough" ε would hide
            # an accountant that diverged by one re-charged step
            "eps_hex": float(eps).hex(),
            "delta": float(delta)}


# -- the subprocess body (the `run` subcommand) -------------------------------

def _build_or_restore(args) -> tuple:
    """(session, fresh_fallback): restore from args.ckpt when asked,
    falling back to a fresh session when nothing durable validates."""
    from ..checkpoint import CheckpointCorruptError
    from ..core import DPConfig
    from ..core.session import PrivacySession, TrainConfig
    tc = TrainConfig(steps=args.steps, n_data=args.n_data, q=args.q,
                     sampler=args.sampler,
                     seq_len=args.seq_len, physical_batch=args.physical_batch,
                     seed=args.seed, lr=0.1, optimizer="sgd",
                     momentum=0.9,              # momentum ON: a resume that
                     #                            drops opt state cannot pass
                     smoke=not args.full,
                     log_every=10 ** 9)         # no eval on the chaos path
    dp = DPConfig(engine=args.engine, clip_norm=0.1,
                  noise_multiplier=args.sigma)
    kw = {"device": args.device}
    if args.resume:
        try:
            return PrivacySession.restore(args.ckpt, args.arch, dp, tc,
                                          **kw), False
        except (FileNotFoundError, CheckpointCorruptError):
            return PrivacySession.from_config(args.arch, dp, tc, **kw), True
    return PrivacySession.from_config(args.arch, dp, tc, **kw), False


def cli_run(args) -> int:
    session, fresh = _build_or_restore(args)
    start = int(session.state.step)
    remaining = args.steps - start
    if remaining < 0:
        raise SystemExit(f"checkpoint at step {start} is beyond the "
                         f"requested total of {args.steps} steps")
    if remaining:
        session.fit(steps=remaining, ckpt=args.ckpt,
                    ckpt_every=args.ckpt_every)
    rec = outcome(session)
    rec["resumed_from"] = None if (not args.resume or fresh) else start
    rec["fresh_fallback"] = bool(args.resume and fresh)
    rec["stream_tile"] = session.describe()["stream_tile"]
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


# -- the parent-side harness --------------------------------------------------

def _spawn(extra_args: List[str], *, fault: Optional[FaultSpec] = None,
           timeout: float = 600.0) -> subprocess.CompletedProcess:
    import repro_torch
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    if fault is not None:
        env[ENV_VAR] = json.dumps([fault.__dict__])
    else:
        env.pop(ENV_VAR, None)
    cmd = [sys.executable, "-m", "repro_torch.resilience.chaos",
           "run"] + extra_args
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _run_args(*, ckpt: str, out: str, arch: str, engine: str, steps: int,
              ckpt_every: int, seed: int, n_data: int, q: float,
              seq_len: int, physical_batch: int, sigma: float,
              sampler: str = "poisson", device: str = "cuda",
              full: bool = False, resume: bool = False) -> List[str]:
    args = ["--ckpt", ckpt, "--out", out, "--arch", arch, "--engine", engine,
            "--steps", str(steps), "--ckpt-every", str(ckpt_every),
            "--seed", str(seed), "--n-data", str(n_data), "--q", str(q),
            "--sampler", sampler, "--seq-len", str(seq_len),
            "--physical-batch", str(physical_batch), "--sigma", str(sigma),
            "--device", device]
    if full:
        args.append("--full")
    if resume:
        args.append("--resume")
    return args


def run_case(point: str, *, workdir: str, spec: Optional[FaultSpec] = None,
             arch: str = "qwen2-0.5b", engine: str = "masked_pe",
             steps: int = 6, ckpt_every: int = 2, seed: int = 0,
             n_data: int = 32, q: float = 0.25, seq_len: int = 8,
             physical_batch: int = 4, sigma: float = 0.8,
             sampler: str = "poisson", device: str = "cuda",
             full: bool = False, timeout: float = 600.0,
             baseline_out: Optional[str] = None) -> dict:
    """One chaos case: baseline || (crash at ``point`` -> resume); compare.

    ``baseline_out`` points at an existing baseline outcome JSON to reuse
    (the suite shares one baseline per config across all fault points).
    Returns a record whose ``match`` field is the invariant verdict.
    """
    spec = spec if spec is not None else \
        DEFAULT_ARMING.get(point, FaultSpec(point))
    if spec.point != point:
        raise ValueError(f"spec targets {spec.point!r}, case is {point!r}")
    cfg = dict(arch=arch, engine=engine, steps=steps, ckpt_every=ckpt_every,
               seed=seed, n_data=n_data, q=q, sampler=sampler,
               seq_len=seq_len, physical_batch=physical_batch, sigma=sigma,
               device=device, full=full)

    if baseline_out is None:
        baseline_out = os.path.join(workdir, "baseline.json")
        proc = _spawn(_run_args(ckpt=os.path.join(workdir, "ckpt-baseline"),
                                out=baseline_out, **cfg), timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"baseline run failed "
                               f"(rc={proc.returncode}):\n{proc.stderr}")
    with open(baseline_out) as f:
        baseline = json.load(f)

    ckpt_dir = os.path.join(workdir, "ckpt-" + point.replace("/", "_"))
    crash_out = os.path.join(ckpt_dir, "crash.json")
    os.makedirs(ckpt_dir, exist_ok=True)
    crashed = _spawn(_run_args(ckpt=ckpt_dir, out=crash_out, **cfg),
                     fault=spec, timeout=timeout)
    fired = (crashed.returncode == spec.exit_code if spec.action == "exit"
             else crashed.returncode != 0)
    if not fired:
        return {"point": point, "match": False, "fired": False,
                "crash_returncode": crashed.returncode,
                "detail": f"fault never fired (rc={crashed.returncode}); "
                          f"stderr:\n{crashed.stderr[-2000:]}"}

    resumed_out = os.path.join(ckpt_dir, "resumed.json")
    proc = _spawn(_run_args(ckpt=ckpt_dir, out=resumed_out, resume=True,
                            **cfg), timeout=timeout)
    if proc.returncode != 0:
        return {"point": point, "match": False, "fired": True,
                "crash_returncode": crashed.returncode,
                "detail": f"resume run failed (rc={proc.returncode}):\n"
                          f"{proc.stderr[-2000:]}"}
    with open(resumed_out) as f:
        resumed = json.load(f)

    match = (resumed["params_sha256"] == baseline["params_sha256"]
             and resumed["eps_hex"] == baseline["eps_hex"]
             and resumed["step"] == baseline["step"])
    return {"point": point, "spec": spec.__dict__, "match": match,
            "fired": True, "crash_returncode": crashed.returncode,
            "baseline": baseline, "resumed": resumed}


def run_suite(*, workdir: str, points: Optional[List[str]] = None,
              **case_kw) -> List[dict]:
    """Every training fault point against ONE shared baseline run."""
    points = points if points is not None else TRAIN_POINTS
    results = []
    baseline_out = None
    for point in points:
        rec = run_case(point, workdir=workdir, baseline_out=baseline_out,
                       **case_kw)
        if baseline_out is None and "baseline" in rec:
            baseline_out = os.path.join(workdir, "baseline.json")
        results.append(rec)
    return results


# -- CLI ----------------------------------------------------------------------

def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--arch", default="qwen2-0.5b")
    p.add_argument("--full", action="store_true",
                   help="the full-width config (default: the reduced one)")
    p.add_argument("--engine", default="masked_pe")
    p.add_argument("--steps", type=int, default=6,
                   help="TOTAL optimizer steps the run should end at")
    p.add_argument("--ckpt-every", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-data", type=int, default=32)
    p.add_argument("--q", type=float, default=0.25)
    p.add_argument("--seq-len", type=int, default=8)
    p.add_argument("--physical-batch", type=int, default=4)
    p.add_argument("--sigma", type=float, default=0.8)
    p.add_argument("--sampler", default="poisson",
                   help="registered sampler for the run (the chaos triple "
                        "pins exactly-once resume per sampler)")
    p.add_argument("--device", default="cuda")


def _case_kw(args) -> dict:
    return dict(arch=args.arch, full=args.full, engine=args.engine,
                steps=args.steps, ckpt_every=args.ckpt_every, seed=args.seed,
                n_data=args.n_data, q=args.q, seq_len=args.seq_len,
                physical_batch=args.physical_batch, sigma=args.sigma,
                sampler=args.sampler, device=args.device)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="repro_torch.resilience.chaos",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="one training run (subprocess body; "
                                     "faults via env)")
    run.add_argument("--ckpt", required=True)
    run.add_argument("--out", required=True)
    run.add_argument("--resume", action="store_true")
    _add_config_args(run)
    smoke = sub.add_parser("smoke", help="one representative crash/resume "
                                         "case; exit 0 iff bitwise match")
    smoke.add_argument("--workdir", default=None)
    _add_config_args(smoke)
    suite = sub.add_parser("suite", help="all training fault points")
    suite.add_argument("--workdir", default=None)
    _add_config_args(suite)
    args = parser.parse_args(argv)

    if args.cmd == "run":
        return cli_run(args)

    workdir = args.workdir or tempfile.mkdtemp(prefix="repro-torch-chaos-")
    if args.cmd == "smoke":
        # the torn window the manifest commit exists to close: state file
        # durable on the SECOND save, manifest never committed
        rec = run_case("ckpt/after_state_before_manifest", workdir=workdir,
                       **_case_kw(args))
        print(json.dumps({k: rec[k] for k in
                          ("point", "match", "fired", "crash_returncode")}))
        if not rec["match"]:
            print(rec.get("detail", json.dumps(rec, indent=1)),
                  file=sys.stderr)
        return 0 if rec["match"] else 1

    results = run_suite(workdir=workdir, **_case_kw(args))
    bad = [r for r in results if not r["match"]]
    for r in results:
        print(f"{'PASS' if r['match'] else 'FAIL'}  {r['point']}")
    if bad:
        print(json.dumps(bad, indent=1), file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
