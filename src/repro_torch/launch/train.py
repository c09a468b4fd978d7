"""End-to-end DP-SGD training driver of the port: a thin CLI over
:class:`repro_torch.core.session.PrivacySession`.

Usage (full-width ViT-Base, then qwen2-0.5b at 1,024 tokens, on the
card)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-base \\
        --engine masked_fused_stream --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --seq-len 1024 --physical 4 --n-data 64 --steps 1

``--smoke`` uses the reduced config; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json

from ..core import DPConfig, clipping
from ..core.session import PrivacySession, TrainConfig
from ..data import available_samplers


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="vit-base")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (default: full width)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--n-data", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=16,
                    help="tokens per example (LM architectures)")
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--describe", action="store_true",
                    help="print the session report before training")
    args = ap.parse_args(argv)
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
                    lr=args.lr, smoke=args.smoke, seed=args.seed),
        device=args.device)
    if args.describe:
        print(json.dumps(session.describe()))
    out = session.fit()
    for rec in out["history"]:
        print(json.dumps(rec))
    print(json.dumps({"final": out["history"][-1] if out["history"] else {},
                      "sigma": round(out["sigma"], 4),
                      "final_eps": round(out["final_eps"], 4)}))
    return out


if __name__ == "__main__":
    main()
