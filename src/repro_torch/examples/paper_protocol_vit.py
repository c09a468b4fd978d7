"""The paper's own protocol on the port: fine-tune a ViT classifier on
synthetic CIFAR-100-like data for 4 optimizer steps at sampling rate q=0.5
(expected logical batch = N/2), ε 8, δ 2.04e-5, clip 4.63 (Table A2 /
Section 3 of Rodriguez Beltran et al.), comparing the clipping engines on
identical seeded logical batches, each driven by its own PrivacySession —
the twin of the reference package's ``examples/paper_protocol_vit.py``.

Run (full-width ViT-Base on the card, or the reduced config on the CPU)::

    PYTHONPATH=src python -m repro_torch.examples.paper_protocol_vit
    PYTHONPATH=src python -m repro_torch.examples.paper_protocol_vit \\
        --device cpu --smoke

It prints each engine's result, each private engine's slowdown against
``nonprivate`` (the paper's Fig. 1), the results as JSON and the sentinel
``PAPER PROTOCOL OK``.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

from ..core import DPConfig
from ..core.session import PrivacySession, TrainConfig

ENGINES = ["nonprivate", "masked_pe", "masked_ghost", "masked_bk"]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.paper_protocol_vit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced ViT (default: full-width ViT-Base)")
    args = ap.parse_args(argv)
    results = {}
    for eng in ENGINES:
        session = PrivacySession.from_config(
            "vit-base",
            DPConfig(engine=eng, clip_norm=4.63),  # the paper's ViT max-grad-norm
            TrainConfig(steps=4, n_data=128, q=0.5, physical_batch=16,
                        target_eps=8.0 if eng != "nonprivate" else None,
                        delta=2.04e-5, lr=3e-4, optimizer="sgd", seed=0,
                        smoke=args.smoke),
            device=args.device)
        out = session.fit()
        results[eng] = {
            "final_loss": out["history"][-1]["loss"],
            "eps": round(out["final_eps"], 3),
            "sigma": round(out["sigma"], 3),
            "throughput_ex_s": round(out["examples_per_s"], 1),
        }
        print(eng, "->", results[eng], flush=True)
        del session

    base = results["nonprivate"]["throughput_ex_s"]
    print("\nrelative throughput vs non-private (paper Fig. 1):")
    for eng in ENGINES[1:]:
        slower = base / max(results[eng]["throughput_ex_s"], 1e-9)
        results[eng]["slowdown_vs_nonprivate"] = round(slower, 3)
        print(f"  {eng:14s} x{slower:.2f} slower")
    print(json.dumps(results, indent=1))
    print("PAPER PROTOCOL OK")
    return results


if __name__ == "__main__":
    main()
