"""Quickstart on the port: DP-SGD fine-tuning with Poisson subsampling, end
to end, through the PrivacySession API, the twin of the reference
package's ``examples/quickstart.py``.

Trains a reduced qwen2-family LM with the ``masked_pe`` engine and AdamW
for 6 steps (n 256, 16 tokens an example, physical batch 16, q 0.25,
ε 8), tracks (ε, δ) with the RDP accountant, checkpoints, then restores the
checkpoint into a ``nonprivate`` session and greedy-decodes 8 tokens.

Run (on the card, or on the CPU)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``--ckpt DIR`` keeps the checkpoint there (default: a temporary directory,
removed at the end).  It prints the session report, the result and the
sentinel ``QUICKSTART OK``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from typing import List, Optional

from ..core import DPConfig
from ..core.session import PrivacySession, TrainConfig

ARCH = "qwen2-0.5b"
TARGET_EPS = 8.0


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_quickstart_")
    try:
        return _run(args.device, ckpt)
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt, ignore_errors=True)


def _run(device, ckpt: str) -> dict:
    session = PrivacySession.from_config(
        ARCH, DPConfig(engine="masked_pe", clip_norm=1.0),
        TrainConfig(steps=6, n_data=256, seq_len=16, physical_batch=16,
                    q=0.25, target_eps=TARGET_EPS, optimizer="adamw",
                    lr=3e-4),
        device=device)
    print(json.dumps(session.describe(), indent=1))

    out = session.fit(ckpt=ckpt)
    eps, delta = session.privacy_spent()
    print(f"\ntrained: sigma={out['sigma']:.3f} eps={eps:.3f} "
          f"(delta={delta:.2e}) throughput={out['examples_per_s']:.1f} ex/s")
    assert eps <= TARGET_EPS + 1e-6, eps

    # restore into a fresh serving session and greedy-decode
    served = PrivacySession.restore(ckpt, ARCH, DPConfig(engine="nonprivate"),
                                    TrainConfig(), device=device)
    meta = served.restored_meta
    print(f"restored checkpoint at step {served.state.step} "
          f"(eps spent: {meta['eps']:.3f})")
    gen = served.generate(batch=2, prompt_len=1, new_tokens=8, max_len=16)
    print("greedy continuation:", gen["generated"])
    print("QUICKSTART OK")
    return {"eps": eps, "delta": delta, "sigma": out["sigma"],
            "history": out["history"], "restored_step": served.state.step,
            "restored_eps": meta["eps"], "generated": gen["generated"]}


if __name__ == "__main__":
    main()
