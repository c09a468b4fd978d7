"""Fault injection: named crash/failure points threaded through the port,
a copy of the reference package's ``resilience/faults.py``.

A :class:`FaultPlan` maps REGISTERED point names (:data:`KNOWN_POINTS`) to an
action that fires on a chosen hit of that point:

  * ``exit``  — ``os._exit(code)``: the process dies instantly, no ``atexit``,
    no ``finally`` blocks, no flushing — the closest a test can get to
    ``kill -9`` / preemption without a second process to do the killing,
  * ``raise`` — raise :class:`FaultInjected` (exception-path testing:
    ``fit``'s mid-loop flush),
  * ``io``    — raise :class:`InjectedIOError` (an ``OSError``) for ``count``
    consecutive hits, then succeed — transient-storage testing for the
    :class:`~repro_torch.checkpoint.AsyncCheckpointer` retry loop.

Call sites put ``fault_point("name")`` at the instants worth crashing at;
with no plan active the call is a single global ``None`` check.  Plans
activate in-process (:func:`activate` / the :func:`active` context manager)
or across a process boundary via the ``REPRO_TORCH_FAULT_PLAN`` environment
variable (JSON, read at import time) — which is how the chaos suite arms a
subprocess training run it is about to kill.  The variable has its own name
so a plan armed for the reference package never arms the port.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
from typing import Dict, Iterable, List, Optional

# Every injectable instant, the reference's list: the chaos suite enumerates
# it, and tests/test_torch_resilience.py holds the port's call sites to it.
# The port has no serving yet, so "serve/mid_iteration" has no call site
# here and stays out of the chaos matrix (TRAIN_POINTS).
KNOWN_POINTS: Dict[str, str] = {
    "ckpt/before_state":
        "save(): before any state bytes are written (nothing new on disk)",
    "ckpt/io_write":
        "save(): the write seam — `io` faults here drive the retry loop",
    "ckpt/after_state_before_manifest":
        "save(): state file durable, manifest NOT committed (the window the "
        "old double-os.replace left a new state paired with stale meta)",
    "ckpt/after_manifest_before_gc":
        "save(): manifest committed, retention GC not yet run",
    "ckpt/mid_d2h":
        "AsyncCheckpointer: background thread, mid device->host copy",
    "fit/after_account_before_ckpt":
        "fit(): privacy accountant charged this step, snapshot not enqueued",
    "fit/step_end":
        "fit(): end of optimizer step N (arm with at=N)",
    "serve/mid_iteration":
        "scheduler.step(): fused step dispatched, retirement bookkeeping "
        "not yet done",
}

DEFAULT_EXIT_CODE = 43          # distinguishable from python tracebacks (1)
ENV_VAR = "REPRO_TORCH_FAULT_PLAN"


class FaultInjected(RuntimeError):
    """Raised by a ``raise``-action fault point."""


class InjectedIOError(OSError):
    """Raised by an ``io``-action fault point (an OSError: retryable)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: fire ``action`` on hits [at, at+count) of ``point``.

    ``at`` is 1-based: ``at=1`` fires on the first time execution reaches
    the point, ``at=3`` on the third (e.g. step 3 of fit for
    ``fit/step_end``).
    """
    point: str
    action: str = "exit"            # exit | raise | io
    at: int = 1
    count: int = 1                  # io: consecutive failing hits
    exit_code: int = DEFAULT_EXIT_CODE

    def __post_init__(self):
        if self.point not in KNOWN_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; registered points: "
                f"{sorted(KNOWN_POINTS)}")
        if self.action not in ("exit", "raise", "io"):
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"expected exit | raise | io")
        if self.at < 1 or self.count < 1:
            raise ValueError(f"at/count must be >= 1 "
                             f"(got at={self.at}, count={self.count})")

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """``point[:action][:at=N][:count=M]`` — the CLI/env syntax."""
        parts = text.split(":")
        kw: dict = {"point": parts[0]}
        for p in parts[1:]:
            if "=" in p:
                k, v = p.split("=", 1)
                if k not in ("at", "count", "exit_code"):
                    raise ValueError(f"unknown fault spec field {k!r}")
                kw[k] = int(v)
            else:
                kw["action"] = p
        return cls(**kw)


class FaultPlan:
    """A set of armed :class:`FaultSpec`\\ s plus per-point hit counters."""

    def __init__(self, specs: Iterable[FaultSpec]):
        self.specs: List[FaultSpec] = list(specs)
        self.hits: Dict[str, int] = {}
        self.fired: List[str] = []          # points that actually fired

    @classmethod
    def single(cls, point: str, action: str = "exit", at: int = 1,
               count: int = 1) -> "FaultPlan":
        return cls([FaultSpec(point=point, action=action, at=at, count=count)])

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        if isinstance(data, dict):
            data = [data]
        return cls([FaultSpec(**d) for d in data])

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(s) for s in self.specs])

    # -- firing --------------------------------------------------------------

    def hit(self, point: str) -> None:
        n = self.hits.get(point, 0) + 1
        self.hits[point] = n
        for spec in self.specs:
            if spec.point != point or not (spec.at <= n < spec.at + spec.count):
                continue
            self.fired.append(point)
            if spec.action == "exit":
                # flush std streams so the parent sees output up to the kill,
                # then die without ANY cleanup (daemon threads, finally
                # blocks, atexit all skipped) — crash semantics
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(spec.exit_code)
            if spec.action == "raise":
                raise FaultInjected(f"injected fault at {point!r} (hit {n})")
            raise InjectedIOError(f"injected I/O failure at {point!r} "
                                  f"(hit {n})")


_ACTIVE: Optional[FaultPlan] = None


def fault_point(name: str) -> None:
    """Mark an injectable instant.  Free when no plan is active."""
    if _ACTIVE is not None:
        _ACTIVE.hit(name)


def activate(plan: Optional[FaultPlan]) -> None:
    global _ACTIVE
    _ACTIVE = plan


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scope a plan to a ``with`` block (tests)."""
    prev = _ACTIVE
    activate(plan)
    try:
        yield plan
    finally:
        activate(prev)


def _install_from_env() -> None:
    text = os.environ.get(ENV_VAR)
    if text:
        activate(FaultPlan.from_json(text))


_install_from_env()
