"""End-to-end DP-SGD training driver of the port: a thin CLI over
:class:`repro_torch.core.session.PrivacySession`.

Usage (full-width ViT-Base, then qwen2-0.5b and mamba2-1.3b at 1,024
tokens, on the card)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-base \\
        --engine masked_fused_stream --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --seq-len 1024 --physical 4 --n-data 64 --steps 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --seq-len 1024 --physical 2 --n-data 64 --steps 1

(``--arch zamba2-1.2b`` likewise.)  The MoE archs (``--arch olmoe-1b-7b``,
``--arch deepseek-v2-lite-16b``) hold more f32 state at full depth than one
card has: run them with ``--smoke`` (``chip_smoke.py`` trains them at full
width, cut in depth).  The frontend families read precomputed frontend
embeddings with their tokens (``EmbeddingDataset``); ``--seq-len`` is the
decoder's (whisper) or the text's (the VLM) token count::

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
        --seq-len 448 --physical 8 --n-data 64 --steps 1

``--arch llama-3.2-vision-90b`` (87.7B params) fits one card only cut in
depth: run it with ``--smoke`` (``chip_smoke.py`` trains 2 of its 100
layers at full width).

``--smoke`` uses the reduced config; ``--device cpu`` runs on the CPU;
``--optimizer adamw`` takes the generic update; ``--ckpt DIR`` makes the
final state durable there; ``--metrics events|sampled`` (with
``--metrics-jsonl``, ``--profile-dir``) turns on telemetry.

Data-parallel over several ranks (the ``dp`` layout of
:mod:`repro_torch.launch.executor`), one process per rank under
``torchrun``: NCCL with each rank on ``cuda:LOCAL_RANK``, or gloo with
``--device cpu``; only rank 0 prints::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch vit-base --mesh 4 --layout dp
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --device cpu --smoke --mesh 2

``--mesh`` takes a preset (``test`` is 2 x 2) or a shape (``4``, ``2x2``);
the world size must equal the mesh's size.  ``--layout dp_sp`` and ``2d``
raise: they are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core import DPConfig, clipping
from ..core.session import PrivacySession, TrainConfig
from ..data import available_samplers
from ..obs import add_cli_args, config_from_args, start_profile, stop_profile
from .executor import (LAYOUTS, LaunchConfig, init_distributed, parse_mesh,
                       require_ported)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="vit-base")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (default: full width)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--n-data", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=16,
                    help="tokens per example (the LMs; the decoder's or "
                         "the text's for the frontend families)")
    ap.add_argument("--physical", type=int, default=32)
    ap.add_argument("--q", type=float, default=0.125)
    ap.add_argument("--sampler", default="poisson",
                    choices=available_samplers())
    ap.add_argument("--engine", default="masked_fused_stream",
                    choices=sorted([*clipping.ENGINES, "nonprivate"]))
    ap.add_argument("--stream-tile", type=int, default=None)
    ap.add_argument("--target-eps", type=float, default=8.0)
    ap.add_argument("--clip-norm", type=float, default=4.63)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--describe", action="store_true",
                    help="print the session report before training")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (the final state is made "
                         "durable there)")
    ap.add_argument("--mesh", default=None,
                    help="a mesh preset (test, production, ...) or shape "
                         "(4, 2x2): data-parallel over that many ranks "
                         "under torchrun; default: local")
    ap.add_argument("--layout", default="dp", choices=list(LAYOUTS))
    add_cli_args(ap)
    args = ap.parse_args(argv)
    launch = require_ported(LaunchConfig(mesh=parse_mesh(args.mesh),
                                         layout=args.layout).validate())
    device = args.device
    joined = not launch.is_local and not torch.distributed.is_initialized()
    if not launch.is_local:
        device = init_distributed(device)
    try:
        return _train(args, launch, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, launch: LaunchConfig, device) -> dict:
    private = args.engine != "nonprivate"
    session = PrivacySession.from_config(
        args.arch,
        DPConfig(clip_norm=args.clip_norm, engine=args.engine,
                 stream_tile=args.stream_tile),
        TrainConfig(steps=args.steps, n_data=args.n_data,
                    seq_len=args.seq_len,
                    physical_batch=args.physical, q=args.q,
                    sampler=args.sampler,
                    target_eps=args.target_eps if private else None,
                    lr=args.lr, optimizer=args.optimizer, smoke=args.smoke,
                    seed=args.seed),
        device=device, obs=config_from_args(args), launch=launch)
    leader = session.executor.rank == 0
    if args.describe and leader:
        print(json.dumps(session.describe()))
    if args.profile_dir:
        start_profile(args.profile_dir)
    try:
        out = session.fit(ckpt=args.ckpt)
    finally:
        if args.profile_dir:
            stop_profile()
        if session.obs.enabled:
            print(session.obs.snapshot(), file=sys.stderr)
        session.obs.close()
    if leader:
        for rec in out["history"]:
            print(json.dumps(rec))
        print(json.dumps({"final": out["history"][-1] if out["history"]
                          else {},
                          "sigma": round(out["sigma"], 4),
                          "final_eps": round(out["final_eps"], 4)}))
    return out


if __name__ == "__main__":
    main()
