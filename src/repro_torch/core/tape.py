"""Tape: the recording context behind ghost-norm and book-keeping clipping,
as in the reference package's ``core/tape.py``.

Every parameterised op of the port's models goes through a primitive of
:mod:`repro_torch.core.layers`, and each primitive consults the Tape:

* ``plain``  — ordinary forward; nothing is recorded (the per-example and
               non-private paths, evaluation).
* ``record`` — each primitive returns ``y + eps[name]`` and records its
               input(s).  One backward pass with respect to every eps then
               yields the per-example output gradient dY at each injection
               point, from which the per-example gradient norms (ghost
               clipping) and the clipped summed gradients (book-keeping)
               follow analytically, without per-example parameter gradients.

PyTorch runs eagerly, so the reference's ``collect`` pass (which learns the
eps shapes before the traced forward) has no counterpart: in record mode
:meth:`Tape.inject` creates each eps as a zero leaf of ``y``'s shape and
dtype that requires grad.  The eps takes the activation dtype, as in the
reference, so every dY reaches the norm math rounded to it (bf16 on
ViT-Base).

Records made inside :func:`scan_blocks` (the layer-stacked transformer
blocks) carry a stack axis: ``stack=('layers',)`` when each step has its own
parameters (norms add over the axis), ``('uses',)`` for names under
``shared/`` whose parameter is re-used every step (the axis is folded into
the sequence axis so cross-use inner products are exact).  The axis is a
Python list of the per-layer tensors, for records and dY alike: nothing is
copied into a stacked tensor, and records that hold one tensor (a block's
``h`` feeds wq, wk and wv) keep sharing it.  Only a ``'uses'`` axis is
stacked, by the companions, where it must be permuted.

Stacks nest: a :func:`scan_blocks` inside another's body (Zamba2's six
mamba layers inside each of its supers) gives its records one list level
per stack, outermost first, and a spec such as ``('layers', 'layers')``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static description of one recorded primitive."""
    kind: str                       # dense | embed | scale | bias | conv1d
    stack: Tuple[str, ...] = ()     # per leading stack axis: 'layers'|'uses'
    param_path: str = ""            # dotted path of the parameter
    meta: Tuple[Tuple[str, Any], ...] = ()   # static extras (conv width ...)

    def with_stack(self, s: str) -> "LayerSpec":
        return dataclasses.replace(self, stack=(s,) + self.stack)

    def get(self, key, default=None):
        return dict(self.meta).get(key, default)


class Tape:
    """Mutable context threaded through the model's forward."""

    PLAIN, RECORD = "plain", "record"

    def __init__(self, mode: str = "plain"):
        if mode not in (self.PLAIN, self.RECORD):
            raise ValueError(f"tape mode {mode!r}; expected 'plain' or "
                             f"'record'")
        self.mode = mode
        # name -> eps leaf, or (stacked names) the list of per-layer leaves;
        # likewise each record entry is a tensor or the per-layer list
        self.eps: Dict[str, Any] = {}
        self.records: Dict[str, Dict[str, Any]] = {}
        self.specs: Dict[str, LayerSpec] = {}

    def inject(self, name: str, y: torch.Tensor, spec: LayerSpec,
               record: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Called by each primitive with its natural output ``y``: returns
        ``y`` (plain) or ``y + eps[name]`` while recording the inputs
        (record)."""
        if self.mode == self.PLAIN:
            return y
        if name in self.specs:
            raise ValueError(f"duplicate tape name: {name!r}")
        self.specs[name] = spec
        self.records[name] = {k: v.detach() for k, v in record.items()}
        eps = torch.zeros_like(y, requires_grad=True)
        self.eps[name] = eps
        return y + eps

    def subtape(self) -> "Tape":
        return Tape(self.mode)

    def absorb(self, scope: str, subs: List["Tape"]) -> None:
        """Merge the per-layer tapes of a layer stack under ``scope``: specs
        gain a leading stack axis, and records and eps leaves become lists
        over it, one entry per layer.  An entry that is itself a list (a
        stack inside the layer) stays one, one list level per stack."""
        first = subs[0]
        for n, spec in first.specs.items():
            full = f"{scope}/{n}"
            if full in self.specs:
                raise ValueError(f"duplicate tape name: {full!r}")
            self.specs[full] = spec.with_stack(
                "uses" if n.startswith("shared/") else "layers")
            self.records[full] = {k: [s.records[n][k] for s in subs]
                                  for k in first.records[n]}
            self.eps[full] = [s.eps[n] for s in subs]


def scan_blocks(tape: Tape, scope: str, body: Callable,
                stacked_params: Dict[str, torch.Tensor], carry,
                n_layers: int):
    """Run ``carry = body(subtape, params_slice, carry)`` for each of the
    ``n_layers`` stacked layers in a Python loop (the reference's
    ``lax.scan``), and in record mode absorb the per-layer records under
    ``scope`` as lists of ``n_layers`` entries.

    ``stacked_params`` leaves have a leading (n_layers,) axis and are
    unbound once.  Parameters the body closes over (re-used every layer)
    must register their primitives under a name starting with ``shared/``
    so their records are folded as 'uses'."""
    per_layer = {n: v.unbind(0) for n, v in stacked_params.items()}
    subs = []
    for layer in range(n_layers):
        sub = tape.subtape()
        carry = body(sub, {n: v[layer] for n, v in per_layer.items()}, carry)
        subs.append(sub)
    if tape.mode == Tape.RECORD and subs:
        tape.absorb(scope, subs)
    return carry
