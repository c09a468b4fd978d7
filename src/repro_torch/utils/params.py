"""Path-keyed parameter dicts and the :class:`FlatGradView` that backs the
single flat f32 gradient accumulator.

The port's parameters are one flat ``{path: tensor}`` dict whose paths are
the reference's dotted ``param_path`` strings (``blocks.attn.wq.w``).  Leaf
order is the reference's ``jax.tree.flatten`` order on its nested dict,
i.e. keys sorted at every level (:func:`path_key`), so every flat-buffer
offset equals the reference's one for one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

# the reference pads the flat buffer to a multiple of 256 (every power-of-two
# data-axis extent up to 256 divides it); the tail stays exactly zero
FLAT_ALIGN = 256


def path_key(path: str) -> Tuple[str, ...]:
    """Sort key giving ``jax.tree.flatten``'s leaf order on a nested dict:
    compare the key chains level by level (not the joined strings)."""
    return tuple(path.split("."))


def flatten_tree(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> ``{dotted path: leaf}`` in flatten order."""
    if isinstance(tree, dict):
        out: Dict[str, object] = {}
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def flatten_params(params, prefix: str = "") -> Dict[str, object]:
    """``{dotted path: leaf}`` of a parameter dict, nested (the reference's
    tree) or already flat (the port's), in its own order: the keys a
    checkpoint stores as ``params.<path>``."""
    out: Dict[str, object] = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(flatten_params(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# the optimizer's flat f32 buffers (SGD's momentum, AdamW's moments)
OPT_BUFFERS = ("mom", "mu", "nu")


def opt_state_tree(opt_state: dict, view: "FlatGradView",
                   per_leaf: bool = False) -> dict:
    """The optimizer state as a checkpoint stores it: ``count`` as an int32
    scalar and each flat buffer either whole (``opt.mom``, as the
    reference's fused SGD keeps it) or, with ``per_leaf``, as a tree of its
    leaves (``opt.mu.<path>``, as the reference keeps AdamW's moments and
    Nesterov's momentum).  The buffers' values are views, not copies."""
    out = {"count": np.int32(opt_state["count"])}
    for k in OPT_BUFFERS:
        buf = opt_state.get(k)
        if buf is not None:
            out[k] = view.unflatten(buf) if per_leaf else buf
    return out


def opt_state_template(opt_state: dict, view: "FlatGradView",
                       per_leaf: bool = False) -> dict:
    """:func:`opt_state_tree`'s structure with zero-size numpy stand-ins of
    each leaf's dtype and shape (the template ``unflatten_state`` reads)."""
    def like(shape):
        return np.broadcast_to(np.float32(0), shape)
    out = {"count": np.int32(0)}
    for k in OPT_BUFFERS:
        if opt_state.get(k) is not None:
            out[k] = ({n: like(view.shapes[i])
                       for i, n in enumerate(view.names)} if per_leaf
                      else like((view.total,)))
    return out


def load_opt_state(arrays: dict, opt_state: dict, view: "FlatGradView"
                   ) -> dict:
    """Copy a restored :func:`opt_state_template`-shaped tree of numpy
    arrays into ``opt_state``'s buffers, in place; returns ``opt_state``."""
    opt_state["count"] = int(arrays["count"])
    for k in OPT_BUFFERS:
        if k not in arrays:
            continue
        got, buf = arrays[k], opt_state[k]
        if isinstance(got, dict):
            for i, n in enumerate(view.names):
                view.segment(buf, i).copy_(torch.from_numpy(
                    np.ascontiguousarray(got[n])))
        else:
            buf.copy_(torch.from_numpy(np.ascontiguousarray(got)))
    return opt_state


def params_from_numpy(tree, device) -> Dict[str, torch.Tensor]:
    """The reference's parameters (a nested dict of numpy arrays) as the
    port's parameters: a ``{path: f32 tensor}`` dict on ``device``."""
    return {path: torch.tensor(np.asarray(leaf, np.float32), device=device)
            for path, leaf in flatten_tree(tree).items()}


def grads_into_tree(flat_grads: Dict[str, torch.Tensor],
                    params: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """``{path: f32 grad}`` shaped like ``params``, in its order; a path no
    entry covers gets f32 zeros (reported by :func:`missing_paths`, not
    silently trained)."""
    out = {}
    for path, p in params.items():
        g = flat_grads.get(path)
        out[path] = (torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) if g is None
                     else g.reshape(p.shape).float())
    return out


def missing_paths(flat_grads: Dict[str, torch.Tensor],
                  params: Dict[str, torch.Tensor]):
    """Paths of ``params`` that no book-keeping gradient covers (should be
    empty)."""
    return sorted(set(params) - set(flat_grads))


@dataclasses.dataclass(frozen=True)
class FlatGradView:
    """Static offsets mapping a parameter dict onto ONE flat f32 buffer of
    length ``total`` (tail-padded to :data:`FLAT_ALIGN`, tail kept zero)."""
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int

    @classmethod
    def for_params(cls, params: Dict[str, torch.Tensor]) -> "FlatGradView":
        names = tuple(sorted(params, key=path_key))
        shapes = tuple(tuple(params[n].shape) for n in names)
        sizes = tuple(math.prod(s) for s in shapes)
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += s
        total = off + ((-off) % FLAT_ALIGN)
        return cls(names, shapes, sizes, tuple(offsets), total)

    @property
    def n_params(self) -> int:
        return sum(self.sizes)

    def zeros(self, device) -> torch.Tensor:
        return torch.zeros(self.total, dtype=torch.float32, device=device)

    def flatten(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Concatenate the dict's leaves (as f32) into the flat layout."""
        parts = [tree[n].reshape(-1).float() for n in self.names]
        pad = self.total - self.n_params
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)

    def add_into(self, acc: torch.Tensor,
                 tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``acc += flatten(tree)`` leaf by leaf into each offset range: the
        same f32 adds, without the flat temporary (a whole gradient's worth
        of memory at an accumulate's peak)."""
        for n, o, k in zip(self.names, self.offsets, self.sizes):
            acc[o:o + k].add_(tree[n].reshape(-1).float())
        return acc

    def segment(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's slice of the flat buffer, reshaped (a view)."""
        o, n = self.offsets[i], self.sizes[i]
        return flat[o:o + n].view(self.shapes[i])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{path: view}`` of the flat buffer."""
        return {n: self.segment(flat, i) for i, n in enumerate(self.names)}
