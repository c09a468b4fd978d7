"""Continuous-batching scheduler (Orca-style iteration-level scheduling):
the reference's ``serve/scheduler.py``.

One scheduler iteration = one fused step over ALL pool slots:

  1. **admit** — queued requests claim free slots; their accumulating
     rows are restored from the pool's template in place (no
     reallocation).  On pools that support it, a new request's prompt is
     matched against RESIDENT slots' prompts through the
     :class:`~repro_torch.serve.cache_pool.PrefixIndex`: the longest
     shared prefix's KV rows are copied on the device and the request
     starts at the shared depth (skipping that much prefill),
  2. **consume** — build per-slot token/position vectors on the host:
     decoding slots feed the token they sampled last step (1 token);
     prefilling slots feed their next ``prefill_chunk`` prompt tokens,
     throttled by the per-iteration ``token_budget``.  The vectors go to
     the params' device in one copy, and one ``prefill_step`` (chunked) or
     ``decode_step`` (every active slot exactly one token) runs for the
     whole pool,
  3. **select** — one sampling call picks every row's next token from the
     logits at its LAST consumed position (an all-greedy iteration takes
     the argmax alone), read back to the host in the iteration's one
     device-to-host copy; rows that consumed their final prompt position
     append it to their output,
  4. **retire** — requests that hit ``max_new_tokens`` (or the cache
     capacity) finish MID-FLIGHT: their slot frees immediately and a queued
     request can be admitted next iteration while the rest of the batch
     keeps decoding.

With ``prefill_chunk == 1`` (the default) prefill runs through the same
decode step, one token per iteration, and each request's tokens depend
only on its own prompt, sampling params and positions, never on batch
composition or admission time: a row's arithmetic at a fixed width does
not depend on its neighbours.  With a larger chunk, a long prompt admitted
into a running batch catches up ``C`` tokens per iteration while its
neighbours decode.  An iteration in which some active slot consumes other
than one token runs at width ``C``, every other at width 1, as in the
reference; the port's GEMMs round a product of ``C`` rows unlike one of 1
(the reference's XLA:CPU chunk path is bit-identical to per-token decode,
the port's is not), so under ``prefill_chunk > 1`` a request's logits are
held to its solo run within the logit bound, not bitwise, and a token may
differ where the top two logits lie within it.  Stalled (``n_tok == 0``)
and free slots leave their cache rows untouched in a chunk iteration.
Rows copied from a sharing source are the bits the sharer would have
written itself at one token an iteration; under chunks its chunk
boundaries move by the shared depth, so its logits are held within the
logit bound.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import NULL_REGISTRY
from ..resilience.faults import fault_point
from .request import (DECODE, FINISH_CANCELLED, FINISH_ERROR, FINISH_LENGTH,
                      FINISH_MAX_LEN, PREFILL, QUEUED, Request, RequestState)


class Scheduler:
    """Iteration-level scheduler over a :class:`~repro_torch.serve.ServeEngine`'s
    cache pool and decode/prefill/sample steps."""

    def __init__(self, engine, admission: str = "continuous",
                 token_budget: Optional[int] = None):
        if admission not in ("continuous", "static"):
            raise ValueError(f"admission must be 'continuous' or 'static', "
                             f"got {admission!r}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        self.engine = engine
        self.admission = admission
        # max tokens consumed per iteration; decoding slots always get their
        # 1 token (stalling a decoder gains nothing: its slot stays busy),
        # the remainder is split over prefilling slots in slot order
        self.token_budget = token_budget
        self.queue: deque = deque()
        self.active: Dict[int, RequestState] = {}   # slot -> state
        self.finished: List[RequestState] = []
        self.iterations = 0
        self.active_slot_steps = 0      # occupancy numerator
        self.tokens_consumed = 0
        self.prefix_hits = 0            # admissions that matched a prefix
        self.prefix_tokens_shared = 0   # prompt tokens skipped via sharing
        self.prompt_tokens_admitted = 0
        self._next_rid = 0

    @property
    def obs(self):
        """The engine's metrics registry (re-read each use, so a registry
        swapped onto the engine takes effect without rebuilding the
        scheduler)."""
        return getattr(self.engine, "obs", NULL_REGISTRY)

    # -- submission ---------------------------------------------------------

    def submit(self, request: Request) -> RequestState:
        if request.prompt_len >= self.engine.max_len:
            raise ValueError(
                f"prompt_len={request.prompt_len} leaves no room to generate "
                f"in a max_len={self.engine.max_len} cache")
        if request.rid is None:
            request = dataclasses.replace(request, rid=self._next_rid)
        self._next_rid = max(self._next_rid, (request.rid or 0)) + 1
        state = RequestState(request)
        self.queue.append(state)
        return state

    @property
    def pending(self) -> int:
        return len(self.queue) + len(self.active)

    # -- one iteration ------------------------------------------------------

    def _admit(self) -> None:
        pool = self.engine.pool
        if not self.queue:
            return      # steady state: nothing to admit
        if self.admission == "static" and self.active:
            return      # static batching: drain the whole group first
        share = self.engine.prefix_sharing
        if share:
            # sync resident write depths so the prefix lookup sees the rows
            # that exist NOW, not last iteration's
            for slot, st in self.active.items():
                pool.positions[slot] = st.pos
        newly: List[int] = []
        now = time.time()
        for _ in range(len(self.queue)):
            if not pool.n_free:
                break
            state = self.queue.popleft()
            slot = pool.insert()
            try:
                state.slot = slot
                state.admitted_at = now
                self.prompt_tokens_admitted += state.prompt_len
                depth = pool.share_prefix(slot, state.prompt) if share else 0
                if depth:
                    self.prefix_hits += 1
                    self.prefix_tokens_shared += depth
                    state.prefix_tokens = depth
                state.pos = depth
                state.status = (PREFILL if state.pos < state.prompt_len
                                else DECODE)
                self.active[slot] = state
                newly.append(slot)
            except Exception:
                # a failed admission (e.g. the prefix copy raising) must
                # neither leak the claimed slot nor drop the request: the
                # slot goes back to the pool and the request back to the
                # FRONT of the queue, then the error propagates
                self.active.pop(slot, None)
                try:
                    pool.evict(slot)
                except ValueError:
                    pass                    # evict itself was what failed
                state.slot = None
                state.pos = 0
                state.prefix_tokens = 0
                state.admitted_at = None
                state.status = QUEUED
                self.queue.appendleft(state)
                raise
        pool.reset(newly)
        if share:
            # reset() zeroes positions; restore the shared depths (the step
            # re-syncs from RequestState.pos anyway: this keeps the pool's
            # vector coherent for same-iteration lookups)
            for slot in newly:
                pool.positions[slot] = self.active[slot].pos

    def step(self) -> bool:
        """Run one scheduler iteration; False when there is nothing to do.

        Exception safe: if the iteration body raises mid-flight (a launch
        failure, an injected fault), :meth:`_recover` retires every
        in-flight request with ``FINISH_ERROR``, returns their slots to the
        pool and reconciles any slot nobody owns; then the error
        propagates.  The pool is left consistent
        (:meth:`~repro_torch.serve.cache_pool.CachePool.assert_consistent`),
        so a caller that catches the error can keep submitting."""
        obs = self.obs
        obs.tick()
        with obs.span("serve/admit"):
            self._admit()
        if not self.active:
            return False
        try:
            return self._step_active(obs)
        except Exception:
            self._recover()
            raise

    def _step_active(self, obs) -> bool:
        pool = self.engine.pool
        B = pool.max_slots
        C = self.engine.prefill_chunk

        # -- per-slot consume counts for this iteration ---------------------
        n_tok = np.zeros(B, np.int32)
        prefilling: List[int] = []
        n_decode = 0
        for slot, st in self.active.items():
            if st.pos < st.prompt_len:
                prefilling.append(slot)
            else:
                n_tok[slot] = 1
                n_decode += 1
        budget_left = (None if self.token_budget is None
                       else max(self.token_budget - n_decode, 0))
        for slot in sorted(prefilling):
            st = self.active[slot]
            want = min(C, st.prompt_len - st.pos)
            if budget_left is not None:
                want = min(want, budget_left)
                budget_left -= want
            n_tok[slot] = want
        # progress is guaranteed: decoders always consume 1, and with no
        # decoders budget_left starts at token_budget >= 1, so the first
        # prefilling slot gets at least one token

        use_chunk = C > 1 and any(n_tok[s] != 1 for s in self.active)
        W = C if use_chunk else 1
        # the one host array (one copy to the device), a row per slot: W
        # token columns, then the position, the consume count, the last
        # consumed position (the sampler's key), the seed, top-k and the
        # temperature's f32 bits.  Slot-major, so the (B, W) tokens keep the
        # row-major layout whose GEMMs every step of a width shares
        host = np.zeros((B, W + 6), np.int32)
        temps = np.zeros(B, np.float32)
        for slot, st in self.active.items():
            n = int(n_tok[slot])
            if st.pos < st.prompt_len:
                host[slot, :n] = st.prompt[st.pos:st.pos + n]
            else:
                host[slot, 0] = st.generated[-1]
            sp = st.request.sampling
            host[slot, W:W + 5] = (st.pos, n, st.pos + max(n, 1) - 1,
                                   sp.seed, sp.top_k)
            temps[slot] = sp.temperature
        host[:, W + 5] = temps.view(np.int32)
        # RequestState.pos is the single source of truth; the pool's [B]
        # vector is synced here, the one place it is consumed
        pool.positions[:] = host[:, W]
        eng = self.engine
        vec = torch.from_numpy(host).to(eng.device)
        tok, pos, last_pos = vec[:, :W], vec[:, W], vec[:, W + 2]

        if use_chunk:
            with obs.span("serve/prefill") as sp:
                logits, pool.cache = eng.prefill_fn(eng.params, pool.cache,
                                                    tok, pos, vec[:, W + 1])
                sp.watch(logits)
        else:
            with obs.span("serve/decode") as sp:
                logits, pool.cache = eng.decode_fn(eng.params, pool.cache,
                                                   tok, pos)
                sp.watch(logits)
        with obs.span("serve/sample") as sp:
            if temps.any():
                tok_dev = eng.sample_fn(logits, last_pos, vec[:, W + 3],
                                        vec[:, W + 5].view(torch.float32),
                                        vec[:, W + 4])
            else:
                tok_dev = eng.greedy_fn(logits)
            sp.watch(tok_dev)
        # the one device-to-host read the iteration REQUIRES (the scheduler
        # needs the sampled ids to build the next iteration's vectors)
        with obs.span("serve/host_sync"):
            next_tok = tok_dev.cpu().numpy()
        # step launched + sampled, retirement bookkeeping not yet done: the
        # window where an exception would leak slots without _recover()
        fault_point("serve/mid_iteration")

        n_sum = int(n_tok.sum())
        self.iterations += 1
        self.active_slot_steps += int((n_tok > 0).sum())
        self.tokens_consumed += n_sum
        obs.inc("serve/iterations")
        obs.inc("serve/tokens", n_sum)

        now = time.time()
        for slot, st in list(self.active.items()):
            n = int(n_tok[slot])
            if not n:
                continue                    # stalled under the token budget
            if st.wants_sample_at(st.pos + n - 1):
                st.generated.append(int(next_tok[slot]))
                if st.first_token_at is None:
                    st.first_token_at = now
            st.pos += n
            st.status = PREFILL if st.pos < st.prompt_len else DECODE
            if len(st.generated) >= st.request.max_new_tokens:
                st.finish(FINISH_LENGTH)
            elif st.pos >= self.engine.max_len:
                st.finish(FINISH_MAX_LEN)
            if st.finished_at is not None:
                # retire mid-flight: the slot frees NOW; a queued request
                # takes it next iteration while the rest keep decoding
                del self.active[slot]
                pool.evict(slot)
                self.finished.append(st)
                self._record_request(st)
        return True

    def _recover(self) -> None:
        """Exception recovery: no slot may stay occupied by a dead request.

        Every in-flight request is finished with ``FINISH_ERROR`` (its
        partial output is kept on the state) and its slot evicted: after a
        failed step the cache rows are suspect, so resuming the request in
        place could decode from half-written KV.  Slots the pool still
        thinks are occupied but no request owns are reconciled too.  Ends by
        asserting pool consistency, so recovery itself can never leak."""
        pool = self.engine.pool
        for slot, st in list(self.active.items()):
            del self.active[slot]
            try:
                pool.evict(slot)
            except ValueError:
                pass            # eviction already happened before the raise
            st.finish(FINISH_ERROR)
            self.finished.append(st)
            self._record_request(st)
        for slot in sorted(pool.occupied):      # ownerless strays
            pool.evict(slot)
        self.obs.inc("serve/recoveries")
        pool.assert_consistent()

    def cancel(self, rid: int) -> bool:
        """Cancel a request by rid: a queued request is removed before it
        ever claims a slot; an in-flight one is retired (slot evicted and
        reusable NEXT iteration, partial output kept).  Returns False when
        the rid is unknown or already finished."""
        for st in list(self.queue):
            if st.rid == rid:
                self.queue.remove(st)
                st.finish(FINISH_CANCELLED)
                self.finished.append(st)
                self._record_request(st)
                return True
        for slot, st in list(self.active.items()):
            if st.rid == rid:
                del self.active[slot]
                self.engine.pool.evict(slot)
                st.finish(FINISH_CANCELLED)
                self.finished.append(st)
                self._record_request(st)
                return True
        return False

    def _record_request(self, st: RequestState) -> None:
        """Per-request lifecycle telemetry at retirement: queue wait, TTFT,
        TPOT, prefix hit, all host timestamps, no device reads."""
        obs = self.obs
        if not obs.enabled:
            return
        obs.inc("serve/requests_finished")
        if st.prefix_tokens:
            obs.inc("serve/prefix_hits")
        for name, val in (("serve/queue", st.queue_time()),
                          ("serve/ttft", st.ttft()),
                          ("serve/tpot", st.tpot())):
            if val is not None:
                obs.observe(name, float(val))
        obs.event("request", rid=st.rid, prompt_len=st.prompt_len,
                  generated=len(st.generated),
                  finish_reason=st.finish_reason,
                  queue_s=st.queue_time(), ttft_s=st.ttft(),
                  tpot_s=st.tpot(), latency_s=st.latency(),
                  prefix_tokens=st.prefix_tokens)

    # -- drain --------------------------------------------------------------

    def run(self, max_iterations: Optional[int] = None) -> List[RequestState]:
        """Step until every submitted request has finished; returns the
        finished states in completion order."""
        it = 0
        while self.queue or self.active:
            if not self.step():
                break
            it += 1
            if max_iterations is not None and it >= max_iterations:
                break
        return self.finished
