"""ServeEngine: the request-level serving entry point, the reference's
``serve/engine.py`` on the decode primitives of the dense LMs, Mamba2 and
the Zamba2 hybrid.

Wires the slot-based :class:`~repro_torch.serve.cache_pool.CachePool` and
the continuous-batching :class:`~repro_torch.serve.scheduler.Scheduler`
through the session's executor (``place_cache``).  The engine serves on the
device its params live on: for a session, the card unless the caller asked
for the CPU.  Nothing moves to the CPU because a card is missing.

Build one from a session (inference spends no privacy budget)::

    session = PrivacySession.from_config("qwen2-0.5b",
                                         DPConfig(engine="nonprivate"))
    engine = ServeEngine.from_session(session, max_slots=8, max_len=128)
    state = engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=16))
    out = engine.run()          # continuous batching until the queue drains

``session.generate`` is a thin single-batch wrapper over this class, and
``python -m repro_torch.launch.serve`` its CLI.

Differences from the reference: the decode and prefill steps are the
model's eager ``decode_step`` and ``prefill_step`` (no jit; the cache is
written in place), and the port has no activation-sharding hooks, so the
reference's ``configure_model`` and ``jit_decode`` have no counterpart.
Under ``prefill_chunk > 1`` a request's tokens are held to its solo run
within the logit bound, not bitwise (the scheduler's docstring says why).
Caches that accumulate (Mamba2's and Zamba2's SSM state and conv tail, a
sliding window's ring) are reset when a slot is reused and refuse prefix
sharing, as in the reference.  Not ported yet (ROADMAP queue 1): the
MoE, MLA, Whisper and VLM caches and the ``extras`` that feed the last two
(item 2), and serving on a mesh (``MeshExecutor.place_cache`` raises;
item 5).
"""
from __future__ import annotations

import math
import time
from typing import Iterable, Optional

import torch

from ..obs import as_registry
from .cache_pool import CachePool
from .request import Request, RequestState, SamplingParams
from .sampling import sample_tokens
from .scheduler import Scheduler


def percentiles(values) -> tuple:
    """(p50, p95) over ``values`` by the nearest-rank method (ceil(q*n)-1);
    None entries (e.g. TTFT of a request that never produced a token) are
    dropped."""
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return 0.0, 0.0

    def rank(q):
        return vals[max(math.ceil(q * len(vals)) - 1, 0)]

    return round(rank(0.5), 4), round(rank(0.95), 4)


def latency_percentiles(results) -> tuple:
    """(p50, p95) request latency in seconds over ``engine.run()`` results."""
    return percentiles([r["latency_s"] for r in results])


def ttft_percentiles(results) -> tuple:
    """(p50, p95) time-to-first-token over ``engine.run()`` results."""
    return percentiles([r.get("ttft_s") for r in results])


# the scheduler's per-iteration phase spans; engine.run's phase_breakdown
# reports exactly these (the registry also holds request-level histograms
# under serve/ — queue/ttft/tpot — which are not phases)
_PHASE_SPANS = frozenset({"serve/admit", "serve/prefill", "serve/decode",
                          "serve/sample", "serve/host_sync"})


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """Every row's argmax as int32 (the first maximum, as ``jnp.argmax``)."""
    return logits.argmax(dim=-1).to(torch.int32)


class ServeEngine:
    """Continuous-batching serving engine over a model's decode primitives."""

    def __init__(self, model, model_cfg, params, *, executor=None,
                 max_slots: int = 4, max_len: int = 64,
                 cache_dtype=torch.float32, admission: str = "continuous",
                 prefill_chunk: int = 1, token_budget: Optional[int] = None,
                 prefix_sharing: bool = True, obs=None):
        if not hasattr(model, "decode_step"):
            raise ValueError(
                f"{getattr(model_cfg, 'name', model)} has no decode path in "
                f"the port: an encoder-only model, or a family whose cache "
                f"is not ported yet (the MoE and MLA LMs, whisper, the VLM: "
                f"ROADMAP queue 1 item 2)")
        if executor is None:
            from ..launch.executor import build_executor
            executor = build_executor(None)
        self.model = model
        self.model_cfg = model_cfg
        self.params = params
        self.executor = executor
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        if self.prefill_chunk > 1 and not hasattr(model, "prefill_step"):
            raise ValueError(
                f"{getattr(model_cfg, 'name', model)} has no prefill_step; "
                f"chunked prefill needs the chunk-shaped decode entry point")
        if self.prefill_chunk > 1 and getattr(model_cfg, "sliding_window", 0):
            # ring caches cannot take a single-scatter chunk once positions
            # wrap the window: fail at construction, not at the first chunk
            raise ValueError(
                f"chunked prefill is unsupported on sliding-window archs "
                f"({getattr(model_cfg, 'name', '?')} has window="
                f"{model_cfg.sliding_window}); use prefill_chunk=1")
        if token_budget is not None and self.prefill_chunk < 2:
            # throttling can stall a slot to 0 tokens, which only the
            # chunked entry point's valid mask can express: the plain
            # decode step consumes 1 token per slot
            raise ValueError("token_budget requires prefill_chunk > 1 "
                             "(prefill-by-decode already consumes the "
                             "minimum 1 token per slot per iteration)")
        self._cache_dtype = cache_dtype
        # telemetry: the scheduler reads this per iteration (admit/prefill/
        # decode/sample/host-sync spans + request lifecycle events); off by
        # default so the serving loop carries no added sync points
        self.obs = as_registry(obs)
        self.decode_fn = model.decode_step
        # chunked prefill: one call consumes (B, C) prompt tokens at per-slot
        # offsets; only an engine with prefill_chunk > 1 takes that path
        self.prefill_fn = (model.prefill_step if self.prefill_chunk > 1
                           else None)
        self.sample_fn = sample_tokens
        # all-greedy iterations skip the sampler's sort + per-row keys (the
        # scheduler picks host-side: temperatures are host values)
        self.greedy_fn = _greedy
        self.pool = CachePool(model, params, self.max_slots, self.max_len,
                              executor=executor, dtype=cache_dtype)
        # prefix sharing only on pools whose every leaf is position-masked
        # KV: an accumulating leaf (a ring) at the resident's depth is NOT
        # the prefix-depth state, so such pools refuse to share rather than
        # serve wrong tokens
        self.prefix_sharing = bool(prefix_sharing
                                   and self.pool.supports_prefix_sharing)
        # admission="static" gates admission on an EMPTY pool (the old
        # fixed-batch generate() discipline): the benchmark baseline
        self.scheduler = Scheduler(self, admission=admission,
                                   token_budget=token_budget)

    @classmethod
    def from_session(cls, session, *, max_slots: int = 4, max_len: int = 64,
                     cache_dtype=torch.float32, prefill_chunk: int = 1,
                     token_budget: Optional[int] = None,
                     prefix_sharing: bool = True,
                     obs=None) -> "ServeEngine":
        """An engine serving the session's current parameters through the
        session's executor.  The session's metrics registry is inherited
        unless ``obs`` overrides it, so train and serve telemetry land in
        one event log."""
        return cls(session.model, session.model_cfg, session.state.params,
                   executor=session.executor, max_slots=max_slots,
                   max_len=max_len, cache_dtype=cache_dtype,
                   prefill_chunk=prefill_chunk, token_budget=token_budget,
                   prefix_sharing=prefix_sharing,
                   obs=obs if obs is not None else getattr(session, "obs",
                                                           None))

    @property
    def device(self) -> torch.device:
        """Where the engine serves: its params' device."""
        return next(iter(self.params.values())).device

    def refresh(self, params) -> None:
        """Serve new parameters.  The cache pool is rebuilt on them."""
        if self.scheduler.pending:
            raise RuntimeError(
                f"cannot refresh a serving engine with "
                f"{self.scheduler.pending} request(s) in flight")
        if params is self.params:
            return
        self.params = params
        self.pool = CachePool(
            self.model, params, self.max_slots, self.max_len,
            executor=self.executor, dtype=self._cache_dtype)

    # -- request API --------------------------------------------------------

    def submit(self, request: Request) -> RequestState:
        return self.scheduler.submit(request)

    def submit_prompt(self, prompt, max_new_tokens: int = 16, *,
                      temperature: float = 0.0, top_k: int = 0,
                      seed: int = 0) -> RequestState:
        return self.submit(Request(
            prompt=prompt, max_new_tokens=max_new_tokens,
            sampling=SamplingParams(temperature=temperature, top_k=top_k,
                                    seed=seed)))

    def step(self) -> bool:
        """One scheduler iteration (admit + decode + retire)."""
        return self.scheduler.step()

    def run(self, requests: Optional[Iterable[Request]] = None) -> dict:
        """Submit ``requests`` (optional), drain the queue, and report
        per-request outputs plus engine-level throughput/occupancy."""
        for r in (requests or ()):
            self.submit(r)
        sch = self.scheduler
        it0, ast0 = sch.iterations, sch.active_slot_steps
        hits0, shared0 = sch.prefix_hits, sch.prefix_tokens_shared
        prompt0 = sch.prompt_tokens_admitted
        phases0 = self.obs.totals("serve/") if self.obs.enabled else {}
        t0 = time.time()
        finished = sch.run()
        dt = max(time.time() - t0, 1e-9)
        iters = sch.iterations - it0
        slot_steps = sch.active_slot_steps - ast0
        prompt_tokens = sch.prompt_tokens_admitted - prompt0
        shared = sch.prefix_tokens_shared - shared0
        results = [s.to_dict() for s in finished]
        gen_tokens = sum(len(s.generated) for s in finished)
        ttft50, ttft95 = ttft_percentiles(results)
        sch.finished = []                   # drained; next run starts fresh
        out = {
            "results": results,
            "iterations": iters,
            "elapsed_s": round(dt, 4),
            "generated_tokens": gen_tokens,
            "tokens_per_s": round(gen_tokens / dt, 1),
            "occupancy": round(slot_steps / max(iters * self.max_slots, 1), 3),
            "ttft_p50_s": ttft50,
            "ttft_p95_s": ttft95,
            "prefix_hits": sch.prefix_hits - hits0,
            "prefix_tokens_shared": shared,
            # fraction of admitted prompt tokens served from a shared prefix
            "prefix_hit_rate": round(shared / max(prompt_tokens, 1), 3),
            "launch": self.executor.describe(),
        }
        if self.obs.enabled:
            # per-phase wall time from THIS run's spans (delta against the
            # registry's running totals, so back-to-back runs don't bleed).
            # calls counts sampled iterations only in "sampled" mode: the
            # mean is exact, the totals are a sample
            pb = {}
            for name, (calls, total_s) in self.obs.totals("serve/").items():
                if name not in _PHASE_SPANS:
                    continue        # request histograms (queue/ttft/tpot)
                c0, t0_s = phases0.get(name, (0, 0.0))
                dc, dt_s = calls - c0, total_s - t0_s
                if dc <= 0:
                    continue
                pb[name[len("serve/"):]] = {
                    "calls": dc,
                    "total_ms": round(dt_s * 1e3, 3),
                    "mean_ms": round(dt_s * 1e3 / dc, 4),
                }
            if pb:
                out["phase_breakdown"] = pb
        return out
