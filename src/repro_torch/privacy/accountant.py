"""Stateful privacy accountant driven by the training loop.

Tracks the (q, sigma, steps, sampler) run-length-encoded history of every
optimizer step and reports the running (eps, delta) under RDP composition.
Each history entry carries the SAMPLER TAG of the steps it charges, and
composition dispatches per tag (:func:`repro_torch.privacy.rdp.compose_for`):
amplified samplers (poisson, balls_and_bins) get the Poisson-subsampled
bound at their effective rate q, unamplified ones (shuffle, full_batch) the
plain Gaussian bound — so a run that mixes samplers, or a shortcut baseline,
is accounted at its TRUE cost rather than silently borrowing amplification
it never had.  The sampler registry guarantees each logical batch really was
drawn by the tagged process, so this accounting is valid — the paper's
"no shortcuts" requirement, extended to the menu.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import rdp


@dataclasses.dataclass
class PrivacyAccountant:
    delta: float
    alphas: Sequence[float] = rdp.DEFAULT_ALPHAS
    _rdp: Optional[np.ndarray] = None   # filled in __post_init__
    history: List[Tuple[float, float, int, str]] = \
        dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self._rdp is None:
            self._rdp = np.zeros(len(self.alphas))

    def step(self, q: float, sigma: float, steps: int = 1,
             sampler: str = "poisson") -> None:
        self._rdp = self._rdp + rdp.compose_for(sampler, q, sigma, steps,
                                                self.alphas)
        # run-length encode: per-step calls at constant (q, sigma, sampler)
        # coalesce, so history (and hence the checkpoint payload, and
        # restore's replay cost) is O(schedule changes), not O(optimizer
        # steps)
        if self.history and self.history[-1][:2] == (q, sigma) \
                and self.history[-1][3] == sampler:
            self.history[-1] = (q, sigma, self.history[-1][2] + steps,
                                sampler)
        else:
            self.history.append((q, sigma, steps, sampler))

    def epsilon(self) -> float:
        return rdp.rdp_to_eps(self._rdp, self.delta, self.alphas)

    def spent(self) -> Tuple[float, float]:
        return self.epsilon(), self.delta

    # -- checkpointing ------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serialisable state: delta, alphas and the full (q, sigma,
        steps, sampler) history.  The RDP vector is NOT stored — from_state
        replays the composition, so the restored accountant is exactly the
        one that would exist had the steps been taken in-process."""
        return {"delta": self.delta,
                "alphas": [float(a) for a in self.alphas],
                "history": [[float(q), float(s), int(n), str(tag)]
                            for q, s, n, tag in self.history]}

    @classmethod
    def from_state(cls, state: dict) -> "PrivacyAccountant":
        acc = cls(delta=float(state["delta"]),
                  alphas=tuple(state.get("alphas", rdp.DEFAULT_ALPHAS)))
        for entry in state.get("history", []):
            # pre-sampler-registry checkpoints carry 3-tuples: those steps
            # were necessarily Poisson (the only sampler wired then)
            q, sigma, steps = entry[0], entry[1], entry[2]
            sampler = entry[3] if len(entry) > 3 else "poisson"
            acc.step(q, sigma, steps=int(steps), sampler=sampler)
        return acc
