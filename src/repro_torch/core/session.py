"""PrivacySession: one object that owns the full DP-SGD lifecycle.

The port's counterpart of the reference package's ``core/session.py``: a
sampler from the registry and the BatchMemoryManager (fixed physical
shapes), a clipping engine from the registry, the RDP accountant with σ
calibrated from ``target_eps``, the optimizer (SGD with momentum through
the fused kernel, Nesterov and AdamW through the generic update), the
telemetry registry (``obs=``), manifest checkpoints (``checkpoint``,
``checkpoint_async``, ``restore``, ``fit(ckpt=...)``) and the ``fit/*``
fault points.  A restored session resumes bitwise: params, optimizer state,
the noise key, the step, the accountant and the streaming tile come back.
It runs on the card unless the caller passes ``device="cpu"``.

``launch=LaunchConfig(mesh=...)`` runs the same ``fit()`` data-parallel
over ``torch.distributed`` (the ``dp`` layout of
:mod:`repro_torch.launch.executor`, one process per rank): each rank
accumulates its rows of every physical batch, the ranks' accumulators are
folded once per logical batch, and every rank applies the same noisy
update.  Checkpoints under more than one rank, the ``dp_sp`` and ``2d``
layouts and serving across ranks are not ported yet.  ``serve_engine``
and ``generate`` serve the session's current parameters through
:class:`repro_torch.serve.ServeEngine`.

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
import sys
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import ArchConfig, get_config
from ..data import SAMPLER_STREAM_VERSION, BatchMemoryManager, make_sampler
from ..data.synthetic import dataset_for_config
from ..launch import costmodel
from ..launch.executor import LaunchConfig, build_executor
from ..models import build
from ..obs import as_registry
from ..optim import (Optimizer, adamw, constant, cosine,
                     linear_warmup_cosine, sgd)
from ..privacy import PrivacyAccountant, calibrate_sigma
from ..privacy import rdp as rdp_mod
from ..resilience.faults import fault_point
from ..utils.device import resolve_device
from ..utils.params import (FlatGradView, load_opt_state, opt_state_template,
                            opt_state_tree)
from . import clipping
from .engine import (DPConfig, TrainState, build_accumulate_fn,
                     build_eval_fn, build_update_fn, fused_sgd, init_state)


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
    optimizer: str = "sgd"               # sgd | adamw
    momentum: float = 0.9                # sgd only
    weight_decay: float = 0.0            # adamw only
    schedule: str = "constant"           # constant | cosine | warmup_cosine
    warmup: int = 0
    smoke: bool = True                   # reduced model config
    seed: int = 0
    log_every: int = 1

    @property
    def resolved_delta(self) -> float:
        return self.delta if self.delta is not None else 1.0 / (10 * self.n_data)


def _build_schedule(tc: TrainConfig) -> Callable:
    if tc.schedule == "constant":
        return constant(tc.lr)
    if tc.schedule == "cosine":
        return cosine(tc.lr, tc.steps)
    if tc.schedule == "warmup_cosine":
        return linear_warmup_cosine(tc.lr, tc.warmup, tc.steps)
    raise ValueError(f"Unknown schedule {tc.schedule!r}; "
                     f"expected constant | cosine | warmup_cosine")


def _build_optimizer(tc: TrainConfig) -> Optimizer:
    sched = _build_schedule(tc)
    if tc.optimizer == "sgd":
        return sgd(sched, momentum=tc.momentum)
    if tc.optimizer == "adamw":
        return adamw(sched, weight_decay=tc.weight_decay)
    raise ValueError(f"Unknown optimizer {tc.optimizer!r}; "
                     f"expected sgd | adamw")


class _StreamTile:
    """The streaming engine's tile: ``tile`` when set, else sized from the
    device's free memory at the first call and then fixed.  (A small object
    of its own, so the session's accumulate function holds no reference
    back to the session.)"""

    def __init__(self, tile: Optional[int], device, n_params: int):
        self.tile, self.device, self.n_params = tile, device, n_params

    def __call__(self, batch_size: int) -> int:
        if self.tile is None:
            self.tile = costmodel.stream_tile_size(
                batch_size, self.n_params,
                costmodel.free_memory_bytes(self.device))
        return self.tile


class PrivacySession:
    """The audited DP-SGD path every entry point of the port goes through."""

    def __init__(self, model, model_cfg: ArchConfig, dp: DPConfig,
                 train: TrainConfig, *, device="cuda", params=None,
                 optimizer: Optional[Optimizer] = None, obs=None,
                 launch: Optional[LaunchConfig] = None):
        dp.validate()
        self.launch = launch if launch is not None else LaunchConfig()
        self.executor = build_executor(self.launch)
        # the sampler's EFFECTIVE per-step rate is what the accountant charges
        self._sampler_q = float(make_sampler(
            train.sampler, n=train.n_data, q=train.q, seed=train.seed).q)
        self.device = resolve_device(device)
        self.model = model
        self.model_cfg = model_cfg
        self.dp = dp
        self.train_cfg = train
        # telemetry: None/off is a strict no-op registry (zero added syncs)
        self.obs = as_registry(obs)
        self.optimizer = optimizer if optimizer is not None \
            else _build_optimizer(train)
        self.accountant = PrivacyAccountant(delta=train.resolved_delta)
        self.loss_fn = model.loss
        if params is None:
            params = model.params()
        for name, p in params.items():
            if p.device != self.device or p.dtype != torch.float32:
                raise ValueError(f"parameter {name!r} is {p.dtype} on "
                                 f"{p.device}; the session trains f32 "
                                 f"parameters on {self.device}")
        # the noise key: two uint32 words, laid out like a PRNGKey(seed + 1),
        # the same on every rank (the noise is drawn once per step)
        self.state: TrainState = self.executor.place_state(init_state(
            params, self.optimizer, (0, (train.seed + 1) & 0xFFFFFFFF)))
        # a streaming engine's tile: DPConfig's, else sized ONCE, at the
        # first accumulate, and kept (and checkpointed): the per-example
        # gradient bits depend on the tile width, so a tile that followed
        # the free memory could differ between a run and its resume
        self._tile = _StreamTile(dp.stream_tile, self.device,
                                 FlatGradView.for_params(params).n_params)
        self._accumulate = build_accumulate_fn(self.loss_fn, dp,
                                               stream_tile=self._tile)
        self._update = build_update_fn(self.optimizer, dp)
        self._evaluate = build_eval_fn(self.loss_fn)
        self.restored_meta: Optional[dict] = None   # set by restore()
        self._ckpt_writer = None                    # lazy AsyncCheckpointer
        self._serve_engines: dict = {}              # serve_engine()'s cache

    @classmethod
    def from_config(cls, model_cfg, dp_cfg: Optional[DPConfig] = None,
                    train_cfg: Optional[TrainConfig] = None, *,
                    device="cuda", params=None,
                    optimizer: Optional[Optimizer] = None,
                    obs=None, launch: Optional[LaunchConfig] = None
                    ) -> "PrivacySession":
        """Build a session from (arch name | ArchConfig, DPConfig,
        TrainConfig) on ``device``.

        With ``train_cfg.target_eps`` set and a private engine, σ is
        calibrated so ``train_cfg.steps`` steps spend at most target_eps at
        δ; ``expected_batch_size`` is derived from the sampler (L = q·N).
        ``params`` (a ``{path: tensor}`` dict, e.g. from
        :func:`~repro_torch.utils.params.params_from_numpy`) replaces the
        model's seeded initialisation; ``optimizer`` replaces the one
        ``train_cfg`` describes; ``obs`` (None, an ``ObsConfig`` or a
        ``MetricsRegistry``) turns on telemetry.  ``launch`` selects the
        executor: ``LaunchConfig(mesh=(4,))`` runs data-parallel over the
        4 ranks of the initialised process group, each on ``device``
        (``cuda:LOCAL_RANK`` after
        :func:`~repro_torch.launch.executor.init_distributed`)."""
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
                   params=params, optimizer=optimizer, obs=obs,
                   launch=launch)

    @classmethod
    def restore(cls, path: str, model_cfg, dp_cfg: Optional[DPConfig] = None,
                train_cfg: Optional[TrainConfig] = None, **kw
                ) -> "PrivacySession":
        """from_config + the full train state of the newest valid
        checkpoint at ``path``: params, optimizer state, the noise key, the
        step, the accountant's history and the streaming tile.  Restoring
        all of it (not just params) is what makes a resumed ``fit()``
        bitwise identical to the uninterrupted run.  Reads the reference
        package's checkpoints too (its noise key then seeds the port's
        per-step seeds, another stream than the reference's)."""
        from ..checkpoint import load as ckpt_load, unflatten_state
        session = cls.from_config(model_cfg, dp_cfg, train_cfg, **kw)
        snap = ckpt_load(path)
        st = session.state
        with torch.no_grad():
            for name, p in st.params.items():
                p.copy_(torch.from_numpy(np.ascontiguousarray(
                    snap.params[name], dtype=np.float32)).reshape(p.shape))
        view = FlatGradView.for_params(st.params)
        if snap.opt_flat:
            per_leaf = not fused_sgd(session.optimizer)
            try:
                load_opt_state(unflatten_state(snap.opt_flat,
                                               opt_state_template(
                                                   st.opt_state, view,
                                                   per_leaf)),
                               st.opt_state, view)
            except (KeyError, ValueError, TypeError) as e:
                warnings.warn(
                    f"checkpoint optimizer state does not match this "
                    f"session's optimizer ({e}); keeping freshly initialised "
                    f"opt state — the resumed run will NOT be bitwise "
                    f"identical to an uninterrupted one", RuntimeWarning,
                    stacklevel=2)
        if "rng" in snap.extra:
            k0, k1 = (int(w) & 0xFFFFFFFF
                      for w in np.asarray(snap.extra["rng"]).reshape(-1)[:2])
            st.rng = (k0, k1)
        st.step = int(snap.step)
        meta = snap.meta or {}
        acc_state = meta.get("accountant")
        if acc_state is not None:
            session.accountant = PrivacyAccountant.from_state(acc_state)
        elif st.step and session.dp.private:
            session.accountant.step(session._sampler_q,
                                    session.dp.noise_multiplier,
                                    steps=st.step,
                                    sampler=session.train_cfg.sampler)
        if session.dp.stream_tile is None and meta.get("stream_tile"):
            session._tile.tile = int(meta["stream_tile"])
        ck_sampler = meta.get("sampler", "poisson")
        if ck_sampler != session.train_cfg.sampler:
            warnings.warn(
                f"checkpoint was written by a {ck_sampler!r}-sampled run but "
                f"this session resumes with {session.train_cfg.sampler!r}: "
                f"the accountant history keeps the old steps' tags (eps "
                f"stays correct) but the executed sampling distribution "
                f"changes at the resume point", RuntimeWarning, stacklevel=2)
        ck_stream = int(meta.get("sampler_stream_version", 1))
        if ck_stream != SAMPLER_STREAM_VERSION:
            warnings.warn(
                f"checkpoint's sampler streams are v{ck_stream} but this "
                f"code draws v{SAMPLER_STREAM_VERSION}: the resumed run is "
                f"NOT bitwise comparable to an uninterrupted v{ck_stream} "
                f"run (the accountant charges what is executed)",
                RuntimeWarning, stacklevel=2)
        session.restored_meta = meta
        return session

    # -- the DP-SGD lifecycle ----------------------------------------------

    @property
    def params(self):
        return self.state.params

    def _place(self, data, mask):
        """A whole physical batch -> this rank's rows on the device."""
        return self.executor.place(data, mask, self.device)

    def _move(self, data, mask):
        """This rank's rows (already selected) -> the device."""
        return self.executor.move(data, mask, self.device)

    def _reduce(self) -> None:
        """The ranks' partial sums -> the logical batch's, before the
        update (the identity in one process).  The non-private update's
        denominator, the examples seen, is summed the same way."""
        st = self.state
        st.grad_acc = self.executor.reduce(st.grad_acc)
        if not self.dp.private:
            st.seen = self.executor.reduce(st.seen)

    def accumulate(self, batch, mask) -> dict:
        """Clip-and-accumulate one physical batch (no optimizer step);
        under a mesh, this rank's rows of it."""
        batch, mask = self._place(batch, mask)
        self.state, metrics = self._accumulate(self.state, batch, mask)
        return metrics

    def update(self, noise: Optional[torch.Tensor] = None) -> None:
        """Noise + optimizer step over the accumulated logical batch,
        advancing the accountant.  ``noise`` replaces the in-kernel draw
        (see :func:`~repro_torch.core.engine.build_update_fn`)."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.fence()     # a pending snapshot's copy first
        self._reduce()
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

    def _record_step_telemetry(self, acc_metrics, examples: int) -> None:
        """Per-step taps: host values (ε, counters) on every tick; the
        batch-aggregated clip/norm metrics the accumulate returns are read
        from the device only on sampled ticks."""
        obs = self.obs
        obs.inc("fit/steps")
        obs.inc("fit/examples", int(examples))
        obs.gauge("dp/eps", float(self.privacy_spent()[0]))
        if obs.sampled_now and acc_metrics:
            for key in ("clip_fraction", "mean_grad_norm", "max_grad_norm"):
                if key in acc_metrics:
                    obs.gauge(f"dp/{key}", float(acc_metrics[key]))

    def evaluate(self, batch, mask=None) -> float:
        if mask is None:
            mask = np.ones(len(next(iter(batch.values()))), np.float32)
        # every rank evaluates the whole batch on the same params
        batch, mask = self._move(batch, mask)
        return float(self._evaluate(self.state.params, batch, mask))

    def fit(self, dataset=None, steps: Optional[int] = None, *,
            noise: Optional[Callable[[int], torch.Tensor]] = None,
            ckpt: Optional[str] = None, ckpt_every: int = 0,
            ckpt_keep: int = 3) -> dict:
        """Run the loop: sampler (``TrainConfig.sampler``) ->
        BatchMemoryManager -> accumulate/update -> accountant
        (-> checkpoint).

        ``steps`` counts the optimizer steps THIS call takes; the sampler
        stream is indexed by the absolute optimizer step, so a restored
        session continues the draws where the uninterrupted run would be.
        ``noise``, a function of the absolute step returning a flat N(0,1)
        tensor, replaces the in-kernel draw (replaying the reference's
        noise).

        With ``ckpt`` a snapshot is enqueued every ``ckpt_every`` steps on
        the background writer (it blocks only while the previous write is
        in flight; that wait is timed as ``fit/ckpt_wait`` and warned about
        when it exceeds one mean step), and the final state is always made
        durable before fit returns; ``ckpt_keep`` manifests are kept."""
        tc = self.train_cfg
        if ckpt:
            self._refuse_ranked_checkpoint()
        steps = steps if steps is not None else tc.steps
        start = self.state.step
        if tc.target_eps is not None and start + steps > tc.steps:
            resumed = f" from step {start}" if start else ""
            raise ValueError(
                f"fit(steps={steps}){resumed} exceeds the {tc.steps} steps "
                f"sigma was calibrated for (target_eps={tc.target_eps}); "
                f"rebuild the session with TrainConfig(steps="
                f"{start + steps}), or pass fit(steps={tc.steps - start}) "
                f"to finish the calibrated run.")
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
                                 place=self._move,
                                 rows=self.executor.local_rows)
        history = []
        obs = self.obs
        t0 = time.time()
        examples = 0
        last_async_at = done = 0
        try:
            for step_i, indices in enumerate(sampler):
                obs.tick()
                with obs.span("fit/accumulate") as sp:
                    acc_metrics = None
                    for pb in bmm.batches(indices):
                        self.state, acc_metrics = self._accumulate(
                            self.state, pb.data, pb.mask)
                    sp.watch(self.state.grad_acc)
                examples += len(indices)
                with obs.span("fit/update") as sp:
                    if self._ckpt_writer is not None:
                        self._ckpt_writer.fence()
                    self._reduce()
                    self.state = self._update(
                        self.state,
                        None if noise is None else noise(start + step_i))
                    sp.watch(self.state.params)
                with obs.span("fit/account"):
                    self._account()
                # the accountant has charged this step but no snapshot
                # records it yet: a kill here must resume from the PREVIOUS
                # snapshot and take this step again with the same draws
                fault_point("fit/after_account_before_ckpt")
                if obs.enabled:
                    self._record_step_telemetry(acc_metrics, len(indices))
                if ckpt and ckpt_every and (step_i + 1) % ckpt_every == 0:
                    # blocks only while a PREVIOUS write is in flight: the
                    # step loop's hidden cost, timed on the host clock
                    t0c = time.perf_counter()
                    self.checkpoint_async(ckpt, keep=ckpt_keep)
                    wait_s = time.perf_counter() - t0c
                    obs.observe("fit/ckpt_wait", float(wait_s))
                    mean_step = (time.time() - t0) / (step_i + 1)
                    if wait_s > mean_step:
                        obs.inc("fit/ckpt_wait_exceeded")
                        warnings.warn(
                            f"async checkpoint wait ({wait_s:.3f}s) exceeded "
                            f"one mean step time ({mean_step:.3f}s): the "
                            f"writer cannot keep up with ckpt_every="
                            f"{ckpt_every} — raise the interval or use "
                            f"faster storage", RuntimeWarning, stacklevel=2)
                    last_async_at = step_i + 1
                if (step_i + 1) % tc.log_every == 0:
                    idx_eval = np.arange(min(tc.physical_batch, tc.n_data))
                    with obs.span("fit/eval"):
                        loss = self.evaluate(
                            dataset.fetch(idx_eval),
                            np.ones(len(idx_eval), np.float32))
                    history.append({
                        "step": step_i + 1, "loss": round(loss, 4),
                        "eps": round(self.privacy_spent()[0], 4),
                        "logical_batch": len(indices),
                        "throughput": round(examples / (time.time() - t0),
                                            1)})
                if obs.snapshot_every and \
                        (step_i + 1) % obs.snapshot_every == 0:
                    print(obs.snapshot(), file=sys.stderr)
                done = step_i + 1
                fault_point("fit/step_end")     # armed with at=N: "kill at
                #                                 step N of this fit call"
        except BaseException:
            # make the snapshot already on its way durable before the
            # loop's exception propagates (a flush failure is swallowed:
            # the loop's exception is the one the caller must see)
            if ckpt:
                try:
                    self.checkpoint_wait()
                except Exception:
                    pass
            raise
        if ckpt:
            if last_async_at and last_async_at == done:
                self.checkpoint_wait()
            else:
                self.checkpoint(ckpt)
        return {"history": history, "sigma": self.dp.noise_multiplier,
                "final_eps": self.privacy_spent()[0],
                "examples_per_s": examples / (time.time() - t0)}

    def privacy_spent(self) -> tuple:
        """(eps, delta) actually spent so far, from the accountant."""
        if not self.dp.private or not self.accountant.history:
            return 0.0, self.accountant.delta
        return self.accountant.spent()

    # -- checkpoints ----------------------------------------------------------

    def _ckpt_meta(self) -> dict:
        eps, delta = self.privacy_spent()
        st = self.state
        return {"arch": getattr(self.model_cfg, "name", "?"),
                "engine": self.dp.engine, "eps": eps, "delta": delta,
                "sampler": self.train_cfg.sampler,
                "sampler_stream_version": SAMPLER_STREAM_VERSION,
                # the full (q, sigma, steps, sampler) history: restore()
                # replays the exact composition
                "accountant": self.accountant.state_dict(),
                "rng": [int(st.rng[0]), int(st.rng[1])],
                "step": int(st.step),
                "count": int(st.opt_state["count"]),
                "optimizer": self.optimizer.kind,
                "stream_tile": self._tile.tile}

    def _refuse_ranked_checkpoint(self) -> None:
        if self.executor.world > 1:
            raise NotImplementedError(
                f"checkpoints under {self.executor.world} ranks are not "
                f"ported yet (ROADMAP queue 1 item 5): every rank would "
                f"write the same manifest")

    def checkpoint_async(self, path: str, *,
                         keep: Optional[int] = None) -> None:
        """Enqueue a checkpoint on the background writer and return; the
        state is copied before the next update can rewrite it (the writer's
        fence).  Blocks only while a previous write is in flight."""
        from ..checkpoint import AsyncCheckpointer
        self._refuse_ranked_checkpoint()
        if self._ckpt_writer is None:
            self._ckpt_writer = AsyncCheckpointer(obs=self.obs)
        if keep is not None:
            self._ckpt_writer.keep = keep
        st = self.state
        view = FlatGradView.for_params(st.params)
        self._ckpt_writer.save(
            path, st.params,
            opt_state_tree(st.opt_state, view,
                           per_leaf=not fused_sgd(self.optimizer)),
            st.step, self._ckpt_meta(),
            extra={"rng": np.array(st.rng, dtype=np.uint32)})

    def checkpoint_wait(self) -> None:
        """Make the last enqueued checkpoint durable (no-op when idle)."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()

    def checkpoint(self, path: str) -> None:
        """Synchronous checkpoint: enqueue + wait until durable."""
        self.checkpoint_async(path)
        self.checkpoint_wait()

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
            "microbatches": dp.microbatches,
            "stream_tile": self._tile.tile,
            "steps": tc.steps,
            "optimizer": self.optimizer.kind or "custom",
            "expected_eps_trajectory": traj,
            "eps_spent": self.privacy_spent()[0],
            "optimizer_steps_taken": self.state.step,
            "device": str(self.device),
            "launch": self.executor.describe(),
        }

    # -- serving ------------------------------------------------------------

    def serve_engine(self, *, max_slots: int = 4, max_len: int = 64,
                     prefill_chunk: int = 1,
                     token_budget: Optional[int] = None,
                     prefix_sharing: bool = True, obs=None):
        """A :class:`~repro_torch.serve.ServeEngine` over the session's
        CURRENT parameters and executor, cached per (max_slots, max_len,
        prefill_chunk, token_budget, prefix_sharing), so repeated
        ``generate()`` calls reuse one engine.  On reuse the engine is
        refreshed, so the params of a ``fit()`` in between are served.
        A family whose decode path the port lacks raises, as
        ``ServeEngine`` does."""
        from ..serve import ServeEngine
        key = (max_slots, max_len, prefill_chunk, token_budget,
               prefix_sharing)
        engine = self._serve_engines.get(key)
        if engine is None:
            engine = ServeEngine.from_session(
                self, max_slots=max_slots, max_len=max_len,
                prefill_chunk=prefill_chunk, token_budget=token_budget,
                prefix_sharing=prefix_sharing, obs=obs)
            self._serve_engines[key] = engine
        else:
            engine.refresh(self.state.params)
            if obs is not None:
                engine.obs = as_registry(obs)
        return engine

    def generate(self, *, batch: int = 4, prompt_len: int = 8,
                 new_tokens: int = 8, max_len: int = 64, greedy: bool = True,
                 temperature: float = 1.0, top_k: int = 0) -> dict:
        """Autoregressive generation with the session's current parameters
        (e.g. after fit() or restore()), a thin single-batch wrapper over
        :class:`~repro_torch.serve.ServeEngine`: ``batch`` synthetic
        requests are submitted together and drained through the
        continuous-batching scheduler.  The prompts are the reference's
        ``jax.random.randint(PRNGKey(seed + 1), (batch, prompt_len), 0,
        vocab)``, bit for bit, drawn on the session's device.
        ``greedy=False`` samples at ``temperature`` with optional ``top_k``
        truncation, each request on its own stream (seeded from
        ``TrainConfig.seed`` + 1 + request index)."""
        from ..serve import Request, SamplingParams
        from ..serve.sampling import prng_key, randint
        cfg, tc = self.model_cfg, self.train_cfg
        if prompt_len + new_tokens > max_len:
            raise ValueError(
                f"prompt_len({prompt_len}) + new_tokens({new_tokens}) "
                f"exceeds max_len={max_len}: the cache would fill before "
                f"generation completes (raise max_len)")
        engine = self.serve_engine(max_slots=batch, max_len=max_len)
        key = prng_key(torch.full((1,), tc.seed + 1, dtype=torch.int64,
                                  device=self.device))
        prompt = randint(key, (batch, prompt_len), 0, cfg.vocab).cpu()
        temp = 0.0 if greedy else temperature
        reqs = [Request(prompt=prompt[i].tolist(), max_new_tokens=new_tokens,
                        sampling=SamplingParams(temperature=temp, top_k=top_k,
                                                seed=tc.seed + 1 + i))
                for i in range(batch)]
        t0 = time.time()
        out = engine.run(reqs)
        dt = max(time.time() - t0, 1e-9)
        by_rid = {r["rid"]: r["generated"] for r in out["results"]}
        first = min(by_rid)
        return {"generated": [by_rid[first + i] for i in range(batch)],
                "tokens_per_s": round(batch * (prompt_len + new_tokens) / dt,
                                      1),
                "iterations": out["iterations"],
                "occupancy": out["occupancy"]}
