"""PrivacySession: one object that owns the full DP-SGD lifecycle.

The port's counterpart of the reference package's ``core/session.py``: a
sampler from the registry and the BatchMemoryManager (fixed physical
shapes), a clipping engine from the registry, the RDP accountant with σ
calibrated from ``target_eps``, and the fused momentum-SGD update.  It runs
on the card unless the caller passes ``device="cpu"``.  Checkpoints, the
mesh executor, observability and fault points are not ported yet.

Quickstart::

    from repro_torch.core import DPConfig
    from repro_torch.core.session import PrivacySession, TrainConfig

    session = PrivacySession.from_config(
        "vit-base", DPConfig(engine="masked_fused_stream", clip_norm=4.63),
        TrainConfig(steps=3, n_data=512, q=0.125, physical_batch=32,
                    target_eps=8.0, smoke=False))
    out = session.fit()
    print(session.privacy_spent(), session.describe())
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import ArchConfig, get_config
from ..data import BatchMemoryManager, make_sampler
from ..data.synthetic import dataset_for_config
from ..models import build
from ..optim import Optimizer, constant, cosine, linear_warmup_cosine, sgd
from ..privacy import PrivacyAccountant, calibrate_sigma
from ..privacy import rdp as rdp_mod
from ..utils.device import resolve_device
from . import clipping
from .engine import (DPConfig, TrainState, build_accumulate_fn,
                     build_eval_fn, build_update_fn, init_state)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Host-side lifecycle knobs: data, sampling, optimizer, seeding."""
    steps: int = 4
    n_data: int = 512
    seq_len: int = 16                    # tokens per example (LM families)
    physical_batch: int = 8
    q: float = 0.25                      # nominal sampling rate (L = q * N)
    sampler: str = "poisson"             # registered sampler name
    target_eps: Optional[float] = None   # auto-calibrate sigma when set
    delta: Optional[float] = None        # default: 1 / (10 * n_data)
    lr: float = 1e-3
    momentum: float = 0.9
    schedule: str = "constant"           # constant | cosine | warmup_cosine
    warmup: int = 0
    smoke: bool = True                   # reduced model config
    seed: int = 0
    log_every: int = 1

    @property
    def resolved_delta(self) -> float:
        return self.delta if self.delta is not None else 1.0 / (10 * self.n_data)


def _build_optimizer(tc: TrainConfig) -> Optimizer:
    if tc.schedule == "constant":
        sched = constant(tc.lr)
    elif tc.schedule == "cosine":
        sched = cosine(tc.lr, tc.steps)
    elif tc.schedule == "warmup_cosine":
        sched = linear_warmup_cosine(tc.lr, tc.warmup, tc.steps)
    else:
        raise ValueError(f"Unknown schedule {tc.schedule!r}; "
                         f"expected constant | cosine | warmup_cosine")
    return sgd(sched, momentum=tc.momentum)


class PrivacySession:
    """The audited DP-SGD path every entry point of the port goes through."""

    def __init__(self, model, model_cfg: ArchConfig, dp: DPConfig,
                 train: TrainConfig, *, device="cuda", params=None):
        dp.validate()
        # the sampler's EFFECTIVE per-step rate is what the accountant charges
        self._sampler_q = float(make_sampler(
            train.sampler, n=train.n_data, q=train.q, seed=train.seed).q)
        self.device = resolve_device(device)
        self.model = model
        self.model_cfg = model_cfg
        self.dp = dp
        self.train_cfg = train
        self.optimizer = _build_optimizer(train)
        self.accountant = PrivacyAccountant(delta=train.resolved_delta)
        self.loss_fn = model.loss
        if params is None:
            params = model.params()
        for name, p in params.items():
            if p.device != self.device or p.dtype != torch.float32:
                raise ValueError(f"parameter {name!r} is {p.dtype} on "
                                 f"{p.device}; the session trains f32 "
                                 f"parameters on {self.device}")
        # the noise key: two uint32 words, laid out like a PRNGKey(seed + 1)
        self.state: TrainState = init_state(
            params, self.optimizer, (0, (train.seed + 1) & 0xFFFFFFFF))
        self._accumulate = build_accumulate_fn(self.loss_fn, dp)
        self._update = build_update_fn(self.optimizer, dp)
        self._evaluate = build_eval_fn(self.loss_fn)

    @classmethod
    def from_config(cls, model_cfg, dp_cfg: Optional[DPConfig] = None,
                    train_cfg: Optional[TrainConfig] = None, *,
                    device="cuda", params=None) -> "PrivacySession":
        """Build a session from (arch name | ArchConfig, DPConfig,
        TrainConfig) on ``device``.

        With ``train_cfg.target_eps`` set and a private engine, σ is
        calibrated so ``train_cfg.steps`` steps spend at most target_eps at
        δ; ``expected_batch_size`` is derived from the sampler (L = q·N).
        ``params`` (a ``{path: tensor}`` dict, e.g. from
        :func:`~repro_torch.utils.params.params_from_numpy`) replaces the
        model's seeded initialisation."""
        device = resolve_device(device)
        dp_cfg = dp_cfg if dp_cfg is not None else DPConfig()
        train_cfg = train_cfg if train_cfg is not None else TrainConfig()
        cfg = get_config(model_cfg) if isinstance(model_cfg, str) \
            else model_cfg
        if train_cfg.smoke:
            cfg = cfg.reduced()
        model = build(cfg, device=device, seed=train_cfg.seed)
        probe = make_sampler(train_cfg.sampler, n=train_cfg.n_data,
                             q=train_cfg.q, seed=train_cfg.seed)
        if not dp_cfg.private:
            sigma = 0.0
        elif train_cfg.target_eps is not None:
            sigma = calibrate_sigma(train_cfg.target_eps, probe.q,
                                    train_cfg.steps, train_cfg.resolved_delta,
                                    sampler=train_cfg.sampler)
        else:
            sigma = dp_cfg.noise_multiplier
        dp_cfg = dataclasses.replace(
            dp_cfg, noise_multiplier=sigma,
            expected_batch_size=probe.expected_batch_size)
        return cls(model, cfg, dp_cfg, train_cfg, device=device,
                   params=params)

    # -- the DP-SGD lifecycle ----------------------------------------------

    @property
    def params(self):
        return self.state.params

    def _place(self, data, mask):
        dev = self.device
        return ({k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in data.items()},
                torch.as_tensor(mask).to(dev, non_blocking=True))

    def accumulate(self, batch, mask) -> dict:
        """Clip-and-accumulate one physical batch (no optimizer step)."""
        batch, mask = self._place(batch, mask)
        self.state, metrics = self._accumulate(self.state, batch, mask)
        return metrics

    def update(self, noise: Optional[torch.Tensor] = None) -> None:
        """Noise + optimizer step over the accumulated logical batch,
        advancing the accountant.  ``noise`` replaces the in-kernel draw
        (see :func:`~repro_torch.core.engine.build_update_fn`)."""
        self.state = self._update(self.state, noise)
        self._account()

    def step(self, batch, mask) -> dict:
        """One logical batch -> one optimizer step."""
        metrics = self.accumulate(batch, mask)
        self.update()
        return metrics

    def _account(self) -> None:
        if self.dp.private:
            self.accountant.step(self._sampler_q, self.dp.noise_multiplier,
                                 sampler=self.train_cfg.sampler)

    def evaluate(self, batch, mask=None) -> float:
        if mask is None:
            mask = np.ones(len(next(iter(batch.values()))), np.float32)
        batch, mask = self._place(batch, mask)
        return float(self._evaluate(self.state.params, batch, mask))

    def fit(self, dataset=None, steps: Optional[int] = None, *,
            noise: Optional[Callable[[int], torch.Tensor]] = None) -> dict:
        """Run the loop: sampler (``TrainConfig.sampler``) ->
        BatchMemoryManager -> accumulate/update -> accountant.

        ``steps`` counts the optimizer steps THIS call takes; the sampler
        stream is indexed by the absolute optimizer step.  ``noise``, a
        function of the absolute step returning a flat N(0,1) tensor,
        replaces the in-kernel draw (replaying the reference's noise)."""
        tc = self.train_cfg
        steps = steps if steps is not None else tc.steps
        start = self.state.step
        if tc.target_eps is not None and start + steps > tc.steps:
            raise ValueError(
                f"fit(steps={steps}) from step {start} exceeds the "
                f"{tc.steps} steps sigma was calibrated for (target_eps="
                f"{tc.target_eps}); rebuild the session with TrainConfig("
                f"steps={start + steps}).")
        if dataset is None:
            dataset = dataset_for_config(self.model_cfg, tc.n_data,
                                         tc.seq_len, seed=tc.seed)
        elif getattr(dataset, "n", tc.n_data) != tc.n_data:
            raise ValueError(
                f"dataset has n={dataset.n} examples but TrainConfig.n_data="
                f"{tc.n_data}; rebuild the session with TrainConfig(n_data="
                f"{dataset.n}).")
        sampler = make_sampler(tc.sampler, n=tc.n_data, q=tc.q, seed=tc.seed,
                               steps=steps, start_step=start)
        bmm = BatchMemoryManager(dataset.fetch, tc.physical_batch,
                                 place=self._place)
        history = []
        t0 = time.time()
        examples = 0
        for step_i, indices in enumerate(sampler):
            for pb in bmm.batches(indices):
                self.state, _ = self._accumulate(self.state, pb.data,
                                                 pb.mask)
            examples += len(indices)
            self.update(None if noise is None else noise(start + step_i))
            if (step_i + 1) % tc.log_every == 0:
                idx_eval = np.arange(min(tc.physical_batch, tc.n_data))
                loss = self.evaluate(dataset.fetch(idx_eval),
                                     np.ones(len(idx_eval), np.float32))
                history.append({
                    "step": step_i + 1, "loss": round(loss, 4),
                    "eps": round(self.privacy_spent()[0], 4),
                    "logical_batch": len(indices),
                    "throughput": round(examples / (time.time() - t0), 1)})
        return {"history": history, "sigma": self.dp.noise_multiplier,
                "final_eps": self.privacy_spent()[0],
                "examples_per_s": examples / (time.time() - t0)}

    def privacy_spent(self) -> tuple:
        """(eps, delta) actually spent so far, from the accountant."""
        if not self.dp.private or not self.accountant.history:
            return 0.0, self.accountant.delta
        return self.accountant.spent()

    # -- reporting ----------------------------------------------------------

    def describe(self) -> dict:
        """Engine, σ, q, δ and the expected ε trajectory over the configured
        number of steps."""
        tc, dp = self.train_cfg, self.dp
        traj = []
        if dp.private and dp.noise_multiplier > 0:
            per_step = rdp_mod.compose_for(tc.sampler, self._sampler_q,
                                           dp.noise_multiplier, 1)
            acc = np.zeros_like(per_step)
            for _ in range(tc.steps):
                acc = acc + per_step
                traj.append(round(rdp_mod.rdp_to_eps(
                    acc, tc.resolved_delta), 4))
        engine = clipping.resolve_engine(dp.engine) if dp.private else None
        return {
            "arch": self.model_cfg.name,
            "engine": dp.engine,
            "engine_traits": {
                t: bool(getattr(engine, t, False))
                for t in ("materializes_pe", "record_based", "streaming")},
            "sigma": dp.noise_multiplier,
            "clip_norm": dp.clip_norm,
            "sampler": tc.sampler,
            "q": self._sampler_q,
            "delta": tc.resolved_delta,
            "expected_batch_size": dp.expected_batch_size,
            "physical_batch": tc.physical_batch,
            "stream_tile": dp.stream_tile,
            "steps": tc.steps,
            "optimizer": "sgd",
            "expected_eps_trajectory": traj,
            "eps_spent": self.privacy_spent()[0],
            "optimizer_steps_taken": self.state.step,
            "device": str(self.device),
        }
