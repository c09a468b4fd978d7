"""Fault tolerance of the port: fault injection, the chaos harness and the
crash-safe invariant, as the reference package's ``resilience``.

**Kill-anywhere + resume ⇒ bitwise identical final params AND
bit-identical ε versus the uninterrupted run**, from three layers:

1. *Exactly-once sampling* — every registered sampler is counter-based, so
   a resumed ``fit()`` continues the draw stream at the restored step.
2. *Durable checkpoints* — :mod:`repro_torch.checkpoint` commits each
   snapshot by ONE atomic manifest rename over content-hashed state blobs,
   falls back to the last good manifest on a torn one, and retries
   transient I/O.
3. *Fault injection* — :mod:`.faults` arms named crash points in the
   checkpointer and ``fit()``; :mod:`.chaos` kills real subprocess training
   runs at them and checks the invariant.
"""
from .faults import (ENV_VAR, KNOWN_POINTS, FaultInjected,  # noqa: F401
                     FaultPlan, FaultSpec, InjectedIOError, activate,
                     active, active_plan, fault_point)

__all__ = ["ENV_VAR", "KNOWN_POINTS", "FaultInjected", "FaultPlan",
           "FaultSpec", "InjectedIOError", "activate", "active",
           "active_plan", "fault_point"]
