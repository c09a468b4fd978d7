"""Serving driver of the port: the :class:`~repro_torch.serve.ServeEngine`
CLI, the twin of the reference package's ``launch/serve.py``.

Serving goes through the same :class:`PrivacySession` that owns training
(a DP-trained checkpoint is one ``restore()`` away) and through the same
executor.  Two modes:

  * default      — ``batch`` synthetic requests through ``session.generate``
                   (itself a thin wrapper over the engine),
  * --requests N — replay a synthetic request trace with mixed prompt/output
                   lengths through the continuous-batching scheduler
                   (``--batch`` is the slot count), reporting throughput,
                   per-request latency, TTFT and the prefix-hit rate.

It serves full width on the card unless ``--smoke`` (the reduced config)
or ``--device cpu`` is given::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --requests 12 --batch 8 --max-len 64 --prefill-chunk 32 \\
        --token-budget 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
        --arch qwen2-0.5b --ckpt DIR

``--mesh`` builds the session on a mesh executor, which refuses to place
the serving cache (serving across ranks is not ported: ROADMAP queue 1
item 5); the error propagates.  The dense LMs, mamba2-1.3b and
zamba2-1.2b have a decode path in the port; the MoE, MLA, Whisper and VLM
families do not yet (ROADMAP queue 1 item 2), and ``ServeEngine``'s error
propagates for them too.
"""
from __future__ import annotations

import argparse
import json
import sys
import warnings

import numpy as np
import torch

from ..core import DPConfig
from ..core.session import PrivacySession, TrainConfig
from ..obs import add_cli_args, config_from_args, start_profile, stop_profile
from .executor import LaunchConfig, init_distributed, parse_mesh


def serve_session(arch: str, *, seed: int = 0, ckpt: str | None = None,
                  mesh=None, device="cuda",
                  smoke: bool = False) -> PrivacySession:
    """An inference-only session: nonprivate engine, no training budget.
    ``mesh`` (a preset or a shape) builds it on the mesh executor."""
    dp = DPConfig(engine="nonprivate")
    tc = TrainConfig(seed=seed, smoke=smoke)
    launch = LaunchConfig(mesh=mesh)
    if ckpt:
        return PrivacySession.restore(ckpt, arch, dp, tc, launch=launch,
                                      device=device)
    return PrivacySession.from_config(arch, dp, tc, launch=launch,
                                      device=device)


def generate(arch: str, *, batch: int = 4, prompt_len: int = 8,
             new_tokens: int = 8, max_len: int = 64, seed: int = 0,
             greedy: bool = True, temperature: float = 1.0, top_k: int = 0,
             ckpt: str | None = None, mesh=None, device="cuda",
             smoke: bool = False) -> dict:
    session = serve_session(arch, seed=seed, ckpt=ckpt, mesh=mesh,
                            device=device, smoke=smoke)
    # a family with no decode path: ServeEngine raises its ValueError
    return session.generate(batch=batch, prompt_len=prompt_len,
                            new_tokens=new_tokens, max_len=max_len,
                            greedy=greedy, temperature=temperature,
                            top_k=top_k)


def synthetic_trace(n: int, vocab: int, max_len: int, seed: int = 0,
                    temperature: float = 0.0, top_k: int = 0,
                    trace_shape: str = "mixed"):
    """A mixed-length request trace, the workload continuous batching
    exists for.  ``trace_shape="mixed"`` draws uniform prompt/output
    lengths; ``"bimodal"`` is mostly short chat turns with every 4th
    request a long completion (the distribution static batching pads
    worst)."""
    from ..serve import Request, SamplingParams
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        if trace_shape == "bimodal":
            pl = int(rng.integers(2, 9))
            nt = (int(rng.integers(3 * max_len // 4, max_len - pl))
                  if i % 4 == 3 else int(rng.integers(2, 9)))
        else:
            lo = max(2, max_len // 16)
            pl = int(rng.integers(lo, max(lo + 1, max_len // 3)))
            nt = int(rng.integers(1, max(2, max_len - pl)))
        reqs.append(Request(
            prompt=rng.integers(0, vocab, size=pl).tolist(),
            max_new_tokens=nt,
            sampling=SamplingParams(temperature=temperature, top_k=top_k,
                                    seed=seed + i)))
    return reqs


def replay(arch: str, *, requests: int, max_slots: int = 8,
           max_len: int = 64, seed: int = 0, temperature: float = 0.0,
           top_k: int = 0, ckpt: str | None = None, mesh=None,
           prefill_chunk: int = 1, token_budget: int | None = None,
           prefix_sharing: bool = True, trace_shape: str = "mixed",
           obs=None, device="cuda", smoke: bool = False) -> dict:
    """Replay a synthetic trace through the continuous-batching scheduler;
    reports throughput, per-request latency AND time-to-first-token
    percentiles (the metric chunked prefill and prefix sharing improve),
    plus the prefix-hit rate."""
    from ..serve import latency_percentiles
    session = serve_session(arch, seed=seed, ckpt=ckpt, mesh=mesh,
                            device=device, smoke=smoke)
    engine = session.serve_engine(max_slots=max_slots, max_len=max_len,
                                  prefill_chunk=prefill_chunk,
                                  token_budget=token_budget,
                                  prefix_sharing=prefix_sharing, obs=obs)
    reqs = synthetic_trace(requests, session.model_cfg.vocab, max_len,
                           seed=seed, temperature=temperature, top_k=top_k,
                           trace_shape=trace_shape)
    out = engine.run(reqs)
    out["latency_p50_s"], out["latency_p95_s"] = latency_percentiles(
        out["results"])
    out["prefill_chunk"] = engine.prefill_chunk
    out["prefix_sharing"] = engine.prefix_sharing
    out["results"] = [{k: v for k, v in r.items() if k != "generated"}
                      for r in out["results"]]     # keep the report readable
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (default: full width)")
    ap.add_argument("--batch", type=int, default=4,
                    help="generate(): request count; --requests mode: the "
                         "engine's slot count")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64,
                    help="cache capacity per slot (tokens)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples per request")
    ap.add_argument("--top-k", type=int, default=0,
                    help="truncate sampling to the k most likely tokens")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=None,
                    help="replay a synthetic N-request trace through the "
                         "continuous-batching scheduler instead of one "
                         "fixed batch")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="prompt tokens consumed per slot per iteration "
                         "(1 = prefill-by-decode; > 1 runs the chunked "
                         "prefill_step)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="max tokens consumed per scheduler iteration "
                         "(throttles prefill; decoding slots always get "
                         "their 1 token)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable prompt prefix-cache sharing across "
                         "requests (pure-KV archs share by default)")
    ap.add_argument("--trace-shape", default=None,
                    choices=["mixed", "bimodal"],
                    help="synthetic trace shape for --requests mode "
                         "(default: mixed)")
    # the older spelling of --trace-shape; --profile belongs to the
    # profiler family (--profile-dir) like everywhere else in the repo
    ap.add_argument("--profile", default=None, choices=["mixed", "bimodal"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", help="serve params restored from a DP-trained "
                                   "checkpoint instead of a fresh init")
    ap.add_argument("--mesh", default=None,
                    help="a mesh preset (test, production, ...) or shape "
                         "(4, 2x2); default: local")
    add_cli_args(ap)
    args = ap.parse_args(argv)
    trace_shape = args.trace_shape
    if args.profile is not None:
        warnings.warn("--profile is deprecated (reserved for profiler "
                      "flags); use --trace-shape", DeprecationWarning,
                      stacklevel=2)
        if trace_shape is None:
            trace_shape = args.profile
    trace_shape = trace_shape or "mixed"
    mesh = parse_mesh(args.mesh)
    device = args.device
    local = LaunchConfig(mesh=mesh).validate().is_local
    joined = not local and not torch.distributed.is_initialized()
    if not local:
        device = init_distributed(device)
    obs = config_from_args(args).build()
    if args.profile_dir:
        start_profile(args.profile_dir)
    try:
        if args.requests:
            out = replay(args.arch, requests=args.requests,
                         max_slots=args.batch, max_len=args.max_len,
                         seed=args.seed, temperature=args.temperature,
                         top_k=args.top_k, ckpt=args.ckpt, mesh=mesh,
                         prefill_chunk=args.prefill_chunk,
                         token_budget=args.token_budget,
                         prefix_sharing=not args.no_prefix_sharing,
                         trace_shape=trace_shape, obs=obs, device=device,
                         smoke=args.smoke)
        else:
            out = generate(args.arch, batch=args.batch,
                           prompt_len=args.prompt_len, new_tokens=args.tokens,
                           max_len=args.max_len, seed=args.seed,
                           greedy=args.temperature == 0.0,
                           temperature=args.temperature, top_k=args.top_k,
                           ckpt=args.ckpt, mesh=mesh, device=device,
                           smoke=args.smoke)
    finally:
        if args.profile_dir:
            stop_profile()
        if obs.enabled:
            print(obs.snapshot(), file=sys.stderr)
        obs.close()
        if joined:
            torch.distributed.destroy_process_group()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
