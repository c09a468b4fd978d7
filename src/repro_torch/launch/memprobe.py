"""Where the card's memory goes at the peak of one accumulate.

For each engine, one accumulate of a fixed physical batch (after a warm-up
call) runs under the CUDA caching allocator's history recorder.  The script
prints the peak bytes allocated over what the session already held, and the
blocks alive at that peak grouped by the innermost frame of this package
that allocated them: a model line for what the forward keeps for the
backward, the engine's grad call for the backward's own buffers, ``"?"``
where no frame of the package is on the stack.  ``autograd`` is the
non-private gradient through ``torch.autograd.grad`` on leaves that require
grad, beside ``nonprivate``'s ``torch.func.grad``: the same sum of
per-example losses by the two routes.

    PYTHONPATH=src python -m repro_torch.launch.memprobe --arch qwen2-0.5b \\
        --seq-len 1024 --physical 4 --engines autograd,nonprivate,masked_bk

The record also goes to ``chiprun_out/memprobe.json`` under the working
directory.
"""
from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from pathlib import Path

PACKAGE = "repro_torch" + os.sep


def _frame_key(frames) -> str:
    for f in frames or ():
        name = f.get("filename", "")
        if PACKAGE in name:
            return (f"{name.rsplit(os.sep, 1)[-1]}:{f.get('line')}:"
                    f"{f.get('name')}")
    return "?"


def live_at_peak(events, top: int = 20) -> dict:
    """From the allocator's trace (``_snapshot()["device_traces"][i]``):
    the peak of the bytes allocated since the trace began, and the blocks
    alive at that peak as ``[frame key, bytes, blocks]``, largest first."""
    def replay(stop=None):
        live, total, peak, at = {}, 0, 0, -1
        for i, ev in enumerate(events):
            if stop is not None and i > stop:
                break
            act, addr = ev["action"], ev["addr"]
            if act == "alloc":
                live[addr] = ev
                total += ev["size"]
                if total > peak:
                    peak, at = total, i
            elif act in ("free_requested", "free_completed") \
                    and addr in live:
                total -= live.pop(addr)["size"]
        return live, peak, at

    _, peak, at = replay()
    live, _, _ = replay(stop=at)
    groups = defaultdict(lambda: [0, 0])
    for ev in live.values():
        g = groups[_frame_key(ev.get("frames"))]
        g[0] += ev["size"]
        g[1] += 1
    rows = sorted(([k, b, n] for k, (b, n) in groups.items()),
                  key=lambda r: -r[1])
    return {"peak_bytes": peak, "live_blocks": len(live),
            "by_frame": rows[:top]}


def _autograd_accumulate(loss_fn):
    import torch
    from ..utils.params import FlatGradView

    def accumulate(state, batch, mask):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        loss = (loss_fn(params, batch) * mask).sum()
        grads = torch.autograd.grad(loss, list(params.values()))
        view = FlatGradView.for_params(state.params)
        view.add_into(state.grad_acc, dict(zip(params, grads)))
        return state, {}
    return accumulate


def probe(session, engines, clip_norm: float = 4.63) -> dict:
    import numpy as np
    import torch
    from ..core.engine import DPConfig, build_accumulate_fn
    from ..data.synthetic import dataset_for_config

    tc, dev = session.train_cfg, session.device
    ds = dataset_for_config(session.model_cfg, tc.n_data, tc.seq_len,
                            seed=tc.seed)
    B = tc.physical_batch
    batch, mask = session._place(ds.fetch(np.arange(B)),
                                 (np.arange(B) < B - B // 4).astype(
                                     np.float32))
    out = {}
    for e in engines:
        tile = B if e == "masked_fused_stream" else None
        acc_fn = (_autograd_accumulate(session.loss_fn) if e == "autograd"
                  else build_accumulate_fn(session.loss_fn, DPConfig(
                      engine=e, clip_norm=clip_norm, stream_tile=tile)))
        acc_fn(session.state, batch, mask)                     # warm-up
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.memory._record_memory_history(
            stacks="python", max_entries=2_000_000)
        try:
            acc_fn(session.state, batch, mask)
            torch.cuda.synchronize(dev)
            snap = torch.cuda.memory._snapshot()
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        trace = snap["device_traces"][dev.index or 0]
        out[e] = {"held_bytes": held,
                  "max_allocated_bytes":
                      torch.cuda.max_memory_allocated(dev),
                  **live_at_peak(trace)}
        session.state.grad_acc.zero_()
        del acc_fn, snap, trace
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.memprobe")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--physical", type=int, default=4)
    ap.add_argument("--engines", default="autograd,nonprivate,masked_bk,"
                                         "masked_pe")
    ap.add_argument("--out", default="chiprun_out/memprobe.json")
    args = ap.parse_args(argv)
    from ..core import DPConfig
    from ..core.session import PrivacySession, TrainConfig
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type != "cuda":
        raise ValueError("the allocator's history is the CUDA allocator's: "
                         "run on the card")
    session = PrivacySession.from_config(
        args.arch, DPConfig(engine="masked_pe", clip_norm=4.63),
        TrainConfig(steps=1, n_data=64, q=0.125,
                    physical_batch=args.physical, seq_len=args.seq_len,
                    target_eps=8.0, momentum=0.0, smoke=False),
        device=device)
    res = {"arch": args.arch, "seq_len": args.seq_len,
           "physical_batch": args.physical,
           "engines": probe(session, args.engines.split(","))}
    for e, r in res["engines"].items():
        print(json.dumps({"engine": e, **r}), flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
