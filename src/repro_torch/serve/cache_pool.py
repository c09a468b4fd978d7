"""Slot-based decode-cache pool: the reference's ``serve/cache_pool.py``.

The pool allocates the model's decode cache ONCE at ``(max_slots, max_len)``
through ``model.init_cache`` and the executor's ``place_cache``, then serves
requests out of its batch rows ("slots") without ever reallocating:

  * :meth:`CachePool.insert` — claim a free slot for a new request,
  * :meth:`CachePool.reset`  — make the claimed slots safe for their new
    occupant: leaves without a position axis (a sliding window's ring, an
    SSM state or conv tail, which accumulate) are restored to the
    template; position-indexed KV rows need nothing
    (stale entries are masked dead: reads stop at the new occupant's own
    write position),
  * :meth:`CachePool.evict`  — return a finished request's slot to the
    free list,
  * :meth:`CachePool.share_prefix` — on admission, copy the longest
    resident prompt prefix's KV rows (found through the
    :class:`PrefixIndex`) into the new slot, so its request skips that
    much prefill.

Per-slot write positions live in the host-side ``positions`` vector (one
int32 per slot), synced from the scheduler's request states each iteration.

The batch and position axes of every cache leaf are found structurally:
``init_cache`` is probed at two batch sizes and at two lengths, and the axis
that changes is the one sought.  A probe calls ``init_cache`` with the
params on PyTorch's ``meta`` device (the reference's ``jax.eval_shape``), so
it allocates nothing.  The leaves are flattened in sorted-key order, the
reference's ``jax.tree.leaves`` order.

The decode step writes the cache IN PLACE, which is the port's form of the
donation the reference guards its template against: the template's leaves
are clones, and ``reset`` and ``share_prefix`` write into the cache's own
tensors (a rebound dict would be lost to the steps).  ``share_prefix``
takes the source, destination and depth as host ints, so it reads nothing
back from the device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.params import flatten_tree


def _leaves(cache) -> List[torch.Tensor]:
    """The cache's leaves in sorted-key order (``jax.tree.leaves``')."""
    return list(flatten_tree(cache).values())


def _probe_cache_shapes(model, params, n_slots: int, max_len: int,
                        dtype) -> List[torch.Size]:
    """init_cache's leaf shapes at batch size ``n_slots``, computed on the
    ``meta`` device (no allocation)."""
    meta = {k: torch.empty_like(p, device="meta") for k, p in params.items()}
    cache = model.init_cache(meta, n_slots, max_len, dtype=dtype)
    return [leaf.shape for leaf in _leaves(cache)]


def detect_batch_axes(model, params, max_len: int, dtype):
    """Per-leaf batch axis of the decode cache, found by probing init_cache
    at two batch sizes and diffing the shapes.  Returns a flat list in
    :func:`_leaves` order."""
    s2 = _probe_cache_shapes(model, params, 2, max_len, dtype)
    s3 = _probe_cache_shapes(model, params, 3, max_len, dtype)
    axes: List[int] = []
    for a, b in zip(s2, s3):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if len(diff) != 1:
            raise ValueError(
                f"cache leaf {tuple(a)} has no unique batch axis (diff vs "
                f"{tuple(b)}: {diff}); the slot pool needs per-slot rows in "
                f"every cache leaf")
        axes.append(diff[0])
    return axes


def detect_pos_axes(model, params, max_len: int, dtype):
    """Per-leaf cache-position axis, or None for leaves that are not
    position-indexed (a sliding window's ring: its shape does not change
    with ``max_len``).  Found by probing init_cache at ``max_len`` and
    ``max_len + 1``; flat list in :func:`_leaves` order."""
    sa = _probe_cache_shapes(model, params, 2, max_len, dtype)
    sb = _probe_cache_shapes(model, params, 2, max_len + 1, dtype)
    axes: List[Optional[int]] = []
    for a, b in zip(sa, sb):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        axes.append(diff[0] if len(diff) == 1 else None)
    return axes


class PrefixIndex:
    """Hash-trie over the prompt token prefixes of RESIDENT slots.

    Each trie node is keyed by a token id and records which slots' prompts
    pass through it.  ``lookup`` walks a new prompt down the trie and
    returns the deepest (slot, depth) whose resident occupant has already
    WRITTEN at least ``depth`` cache rows (the ``valid_depth`` callable:
    rows beyond a resident's current position do not exist yet, and rows
    beyond its prompt hold generated tokens, which are not part of any
    prompt prefix).
    """

    def __init__(self):
        self._root: Dict = {}               # token -> [slots_set, children]
        self._tokens: Dict[int, tuple] = {}  # slot -> registered prompt

    def register(self, slot: int, tokens) -> None:
        tokens = tuple(int(t) for t in tokens)
        if slot in self._tokens:
            self.unregister(slot)
        self._tokens[slot] = tokens
        node = self._root
        for t in tokens:
            entry = node.setdefault(t, [set(), {}])
            entry[0].add(slot)
            node = entry[1]

    def unregister(self, slot: int) -> None:
        tokens = self._tokens.pop(slot, None)
        if tokens is None:
            return
        node = self._root
        for t in tokens:
            entry = node.get(t)
            if entry is None:
                return
            entry[0].discard(slot)
            nxt = entry[1]
            if not entry[0]:
                del node[t]         # prune: no slot passes through anymore
                return
            node = nxt

    def lookup(self, tokens, valid_depth, exclude=()) -> tuple:
        """Longest (slot, depth) prefix match among registered slots with
        ``valid_depth(slot) >= depth``; (None, 0) when nothing matches.  At
        the deepest depth the lowest slot wins."""
        best_slot, best_depth = None, 0
        node = self._root
        for d, t in enumerate(tokens):
            entry = node.get(int(t))
            if entry is None:
                break
            cands = [s for s in entry[0]
                     if s not in exclude and valid_depth(s) >= d + 1]
            if cands:
                best_slot, best_depth = min(cands), d + 1
            node = entry[1]
        return best_slot, best_depth


class CachePool:
    """A fixed pool of ``max_slots`` independent decode-cache rows."""

    def __init__(self, model, params, max_slots: int, max_len: int, *,
                 executor=None, dtype=torch.float32):
        if executor is None:
            from ..launch.executor import build_executor
            executor = build_executor(None)
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        # each cache leaf's slot axis and position axis (None: the leaf
        # accumulates), in flatten order
        self.batch_axes =detect_batch_axes(model, params, max_len, dtype)
        self.pos_axes = detect_pos_axes(model, params, max_len, dtype)
        # leaves WITHOUT a position axis need a template restore on slot
        # reuse (a ring's rows are reused modulo the window); position-
        # indexed KV leaves do not: decode writes position pos and attention
        # masks reads to <= pos, so every visible entry was written by the
        # slot's current occupant and stale rows are dead by construction
        self._needs_reset = [ax is None for ax in self.pos_axes]
        cache = model.init_cache(params, self.max_slots, self.max_len,
                                 dtype=dtype)
        self.cache = executor.place_cache(cache, self.max_slots)
        # the template holds each slot's pristine row; only the needs-reset
        # leaves are kept (no second cache's worth of KV).  They are clones:
        # the decode step writes the cache in place
        self._template_leaves = [
            leaf.clone() for leaf, need in
            zip(_leaves(self.cache), self._needs_reset) if need]
        self.positions = np.zeros(self.max_slots, np.int32)
        self._free: List[int] = list(range(self.max_slots))
        # prefix sharing: only position-masked-KV pools can share. An
        # accumulating leaf (a ring, an SSM state or conv tail) at a
        # resident's CURRENT depth is not the state at the prefix depth, so
        # copying it would be wrong; such pools refuse to share (index None)
        self.supports_prefix_sharing = all(
            ax is not None for ax in self.pos_axes)
        self.prefix_index = (PrefixIndex() if self.supports_prefix_sharing
                             else None)
        self._refcount = np.zeros(self.max_slots, np.int64)
        self._pending_free: set = set()

    # -- slot lifecycle -----------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    def insert(self) -> Optional[int]:
        """Claim a free slot (lowest index first); None when full.  The
        caller must :meth:`reset` the slot before decoding into it."""
        if not self._free:
            return None
        self._free.sort()
        slot = self._free.pop(0)
        self.positions[slot] = 0
        return slot

    def evict(self, slot: int) -> None:
        """Return a slot to the free list (its stale rows are cleared by the
        reset that precedes the next insert).  A slot pinned as the source
        of an in-flight prefix copy is parked instead, and freed when the
        last pin drops: evict never frees rows still being copied from."""
        if slot in self._free or slot in self._pending_free:
            raise ValueError(f"slot {slot} is already free")
        if self.prefix_index is not None:
            self.prefix_index.unregister(slot)
        self.positions[slot] = 0
        if self._refcount[slot] > 0:
            self._pending_free.add(slot)
        else:
            self._free.append(slot)

    def pin(self, slot: int) -> None:
        """Hold ``slot``'s rows live across an evict (a prefix-copy source).

        In the single-threaded scheduler the pin window is the synchronous
        ``share_prefix`` call itself, so evict can only observe a pin if a
        caller holds one across iterations: the refcount is the contract an
        overlapped copy path builds on."""
        self._refcount[slot] += 1

    def unpin(self, slot: int) -> None:
        self._refcount[slot] -= 1
        if self._refcount[slot] < 0:
            raise ValueError(f"slot {slot} unpinned more than pinned")
        if self._refcount[slot] == 0 and slot in self._pending_free:
            self._pending_free.discard(slot)
            self._free.append(slot)

    def assert_consistent(self) -> None:
        """Structural invariants of the slot lifecycle; raises AssertionError
        naming the violation.  The scheduler's exception recovery calls it
        to prove a mid-iteration failure left no leaked slot, negative
        refcount or stale prefix-index entry behind."""
        every = set(range(self.max_slots))
        free = set(self._free)
        assert len(free) == len(self._free), \
            f"duplicate slots in free list: {sorted(self._free)}"
        assert free <= every, f"free list out of range: {sorted(free - every)}"
        assert self._pending_free <= every, \
            f"pending-free out of range: {sorted(self._pending_free - every)}"
        assert not free & self._pending_free, \
            f"slots both free and pending-free: " \
            f"{sorted(free & self._pending_free)}"
        bad_ref = [s for s in range(self.max_slots) if self._refcount[s] < 0]
        assert not bad_ref, f"negative refcounts on slots {bad_ref}"
        for s in sorted(free):
            assert self._refcount[s] == 0, \
                f"free slot {s} still pinned (refcount {self._refcount[s]})"
            assert self.positions[s] == 0, \
                f"free slot {s} has nonzero position {self.positions[s]}"
        for s in sorted(self._pending_free):
            assert self._refcount[s] > 0, \
                f"slot {s} parked pending-free without a pin"
            assert self.positions[s] == 0, \
                f"pending-free slot {s} has nonzero position " \
                f"{self.positions[s]}"
        if self.prefix_index is not None:
            occupied = every - free - self._pending_free
            registered = set(self.prefix_index._tokens)
            assert registered <= occupied, \
                f"prefix index still registers non-occupied slots " \
                f"{sorted(registered - occupied)}"

    @property
    def occupied(self) -> set:
        """Slots neither free nor parked pending-free: each should be owned
        by exactly one active request (the scheduler reconciles strays)."""
        return (set(range(self.max_slots)) - set(self._free)
                - self._pending_free)

    # -- prefix sharing ------------------------------------------------------

    def share_prefix(self, slot: int, tokens) -> int:
        """On admission into ``slot``: copy the longest matching resident
        prompt prefix's KV rows into ``slot`` and register ``tokens`` so
        later admissions can match against this slot.  Returns the shared
        depth (0 = no match or sharing unsupported); the new occupant
        starts at that depth."""
        if self.prefix_index is None:
            return 0
        tokens = [int(t) for t in tokens]

        def valid_depth(s):
            # rows a resident has WRITTEN, capped at its prompt length
            # (rows past the prompt hold generated tokens)
            return min(int(self.positions[s]),
                       len(self.prefix_index._tokens.get(s, ())))

        # cap at len-1: the new request must consume >= 1 token to produce
        # the logits its first generated token is sampled from
        src, depth = self.prefix_index.lookup(tokens[:-1], valid_depth,
                                              exclude=(slot,))
        if src is not None and depth > 0:
            self.pin(src)
            try:
                self._share_fn(self.cache, src, slot, depth)
            finally:
                self.unpin(src)
        self.prefix_index.register(slot, tokens)
        self.positions[slot] = depth if src is not None else 0
        return depth if src is not None else 0

    def _share_fn(self, cache, src: int, dst: int, depth: int) -> None:
        """Copy rows [0, depth) of every leaf from slot ``src`` to ``dst``
        along each leaf's (batch, position) axes, in place: one device copy
        per leaf, every index a host int (no read from the device)."""
        for leaf, bax, pax in zip(_leaves(cache), self.batch_axes,
                                  self.pos_axes):
            pax_r = pax - (1 if bax < pax else 0)   # pos axis after select
            leaf.select(bax, dst).narrow(pax_r, 0, depth).copy_(
                leaf.select(bax, src).narrow(pax_r, 0, depth))

    def reset(self, slots: Sequence[int]) -> None:
        """Make ``slots`` safe for a new occupant: every needs-reset leaf
        takes the template's rows at the slots, one in-place row copy per
        leaf and slot (a host-int index: no transfer to the device, no host
        sync).  Position-masked KV rows are left as they are: their stale
        entries are unreachable, so a pure-KV pool resets for free."""
        for s in slots:
            self.positions[s] = 0
        tmpl = iter(self._template_leaves)
        for c, ax, need in zip(_leaves(self.cache), self.batch_axes,
                               self._needs_reset):
            if need:
                t = next(tmpl)
                for s in slots:
                    c.select(ax, s).copy_(t.select(ax, s))
