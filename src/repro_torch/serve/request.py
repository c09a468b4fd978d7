"""Request-level serving state: the reference's ``serve/request.py``, a
copy (plain Python and numpy), with its names and ``to_dict`` keys.

A :class:`Request` is what a client submits: prompt tokens, per-request
sampling parameters and budget.  A :class:`RequestState` is the scheduler's
mutable view of one request as it moves QUEUED -> PREFILL -> DECODE ->
FINISHED through the continuous-batching loop (see ``serve/scheduler.py``).

``SamplingParams(temperature=0)`` is greedy decoding; a positive temperature
samples from the (optionally top-k truncated) softmax with a random stream
derived from ``(seed, position)`` only, so the tokens a request produces
are independent of which slot it lands in and which other requests share
the batch (``tests/test_torch_serve.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

# RequestState.status values
QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
FINISHED = "finished"

# finish reasons
FINISH_LENGTH = "length"        # produced max_new_tokens
FINISH_MAX_LEN = "max_len"      # hit the cache capacity (max_len slots)
FINISH_ERROR = "error"          # retired by the scheduler's exception
#                                 recovery (slot evicted, output partial)
FINISH_CANCELLED = "cancelled"  # cancelled via Scheduler.cancel(rid)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs.  temperature == 0 -> greedy (argmax);
    top_k == 0 -> no truncation."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def validate(self) -> "SamplingParams":
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        return self


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt tokens + budget + sampling params."""
    prompt: Sequence[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = SamplingParams()
    rid: Optional[int] = None            # assigned by the scheduler if None
    deadline: Optional[float] = None     # absolute time.time() deadline hint

    def __post_init__(self):
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")
        self.sampling.validate()

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


class RequestState:
    """Scheduler-owned lifecycle record for one request.

    ``pos`` counts tokens consumed so far — the cache position the NEXT
    decode step writes to.  While ``pos < prompt_len`` the request is in its
    prefill phase (teacher-forced prompt tokens); afterwards each step feeds
    back the previously sampled token.
    """

    def __init__(self, request: Request):
        self.request = request
        self.prompt = np.asarray(request.prompt, np.int32)
        self.generated: List[int] = []
        self.status = QUEUED
        self.slot: Optional[int] = None
        self.pos = 0                       # tokens consumed == next write pos
        self.finish_reason: Optional[str] = None
        self.submitted_at = time.time()
        self.admitted_at: Optional[float] = None   # claimed a pool slot
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.prefix_tokens = 0             # prompt tokens served via sharing

    # -- scheduling helpers -------------------------------------------------

    @property
    def rid(self):
        return self.request.rid

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def wants_sample_at(self, pos: int) -> bool:
        """Does the step consuming position ``pos`` produce a sampled token?
        (Logits at the last prompt position onward are sampled; earlier
        prefill logits are teacher-forced away.)"""
        return pos >= self.prompt_len - 1

    def finish(self, reason: str) -> None:
        self.status = FINISHED
        self.finish_reason = reason
        self.finished_at = time.time()

    # -- reporting ----------------------------------------------------------

    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def ttft(self) -> Optional[float]:
        """Time to first token: submit -> first sampled token (includes
        queue wait and prefill — the latency chunked prefill and prefix
        sharing attack)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    def queue_time(self) -> Optional[float]:
        """Submit -> admission (claimed a pool slot): pure scheduling wait,
        the component of TTFT that admission policy and slot pressure own."""
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    def tpot(self) -> Optional[float]:
        """Time per output token over the DECODE phase (first sampled token
        -> finish, averaged over the remaining tokens) — steady-state decode
        speed, the number TTFT improvements must not regress."""
        if (self.finished_at is None or self.first_token_at is None
                or len(self.generated) < 2):
            return None
        return ((self.finished_at - self.first_token_at)
                / (len(self.generated) - 1))

    def to_dict(self) -> dict:
        return {"rid": self.rid, "prompt_len": self.prompt_len,
                "generated": list(self.generated),
                "finish_reason": self.finish_reason,
                "latency_s": self.latency(),
                "ttft_s": self.ttft(),
                "queue_s": self.queue_time(),
                "tpot_s": self.tpot(),
                "prefix_tokens": self.prefix_tokens}
