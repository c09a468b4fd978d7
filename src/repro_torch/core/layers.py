"""DP layer primitives of the port, as in the reference package's
``core/layers.py``.

Every parameterised op of the port's models goes through one of six
primitives:

    dense            y = x @ W (+ b)
    dense_stacked    y[e] = x[e] @ W[e] (MoE experts; and its pair form)
    embed            y = E[ids]
    scale            y = x * g          (g broadcast over batch/time)
    bias             y = x + b          (b broadcast over batch/time)
    conv1d_depthwise y = causal depthwise conv (Mamba2's conv frontend)

Each consults the :class:`~repro_torch.core.tape.Tape` and comes with two
analytic companions the clipping engines use:

    per_example_sq_norm(spec, record, dY) -> (B,) per-example squared norms
    bk_grads(spec, record, dY, coef)      -> {param_path: clipped summed grad}

Together they implement Ghost Clipping (Li et al., 2022) and Book-Keeping
(Bu et al., 2023), for layer-stacked blocks and exact parameter re-use.  The
forward arithmetic is the reference's: a dense runs its product in f32 (a
bf16 ``x`` is upcast, as JAX promotes bf16 x f32), casts to ``x``'s dtype,
then adds the bias; scale and bias cast the parameter to ``x``'s dtype.  The
norm math upcasts to f32 inside each companion.

The reference's ``set_norm_backend("xla")`` is not ported: on the card it
would hide the ``ghost_norm_dense`` kernel behind an einsum.  ``_FORCE_PATH``
is: tests and ``chip_smoke.py`` set it to run one side of the Mixed-Ghost
rule on every dense layer.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.ghost_norm import ghost_norm_dense
from .tape import LayerSpec, Tape

# "ghost" | "direct" forces one side of the Mixed-Ghost rule (tests)
_FORCE_PATH: Optional[str] = None


# ---------------------------------------------------------------------------
# forward primitives
# ---------------------------------------------------------------------------

def dense(tape: Tape, name: str, x, w, b=None, *, param_path: str):
    """y[..., o] = x[..., i] @ w[i, o] (+ b[o])."""
    y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    spec = LayerSpec("dense", param_path=param_path,
                     meta=(("has_bias", b is not None),))
    return tape.inject(name, y, spec, {"x": x})


def _stacked_matmul(x, w):
    """x (E, ..., i) @ w (E, i, o) per expert, in f32, cast to x's dtype."""
    E = x.shape[0]
    y = torch.bmm(x.float().reshape(E, -1, x.shape[-1]), w.float())
    return y.reshape(x.shape[:-1] + (w.shape[-1],)).to(x.dtype)


def dense_stacked(tape: Tape, name: str, x, w, *, param_path: str):
    """Per-expert dense: x (E, ..., i), w (E, i, o) -> (E, ..., o).

    The leading E axis is a 'layers' stack axis of the spec (a tensor axis
    of the record, not a list level), so expert weights get exact
    per-example ghost norms and BK grads as layer-stacked weights do."""
    y = _stacked_matmul(x, w)
    spec = LayerSpec("dense", param_path=param_path,
                     meta=(("has_bias", False),), stack=("layers",))
    return tape.inject(name, y, spec, {"x": x})


def dense_stacked_pair(tape: Tape, name: str, x, w1, w3, *,
                       param_path1: str, param_path2: str):
    """Two per-expert denses on one input (SwiGLU's gate and up): the input
    is recorded once, under ``{name}.a``; the second spec carries a
    ``record_of`` pointer to it, which :func:`resolve_record` follows."""
    y1 = _stacked_matmul(x, w1)
    y2 = _stacked_matmul(x, w3)
    s1 = LayerSpec("dense", param_path=param_path1,
                   meta=(("has_bias", False),), stack=("layers",))
    s2 = LayerSpec("dense", param_path=param_path2,
                   meta=(("has_bias", False), ("record_of", f"{name}.a")),
                   stack=("layers",))
    y1 = tape.inject(f"{name}.a", y1, s1, {"x": x})
    y2 = tape.inject(f"{name}.b", y2, s2, {})
    return y1, y2


def resolve_record(records, name: str, spec: LayerSpec):
    """The record of ``name``, following a ``record_of`` alias to a sibling
    primitive of the same scope."""
    ref = spec.get("record_of")
    if not ref:
        return records[name]
    prefix = name.rsplit("/", 1)[0] + "/" if "/" in name else ""
    return records[prefix + ref]


def embed(tape: Tape, name: str, ids, table, *, param_path: str):
    """y = table[ids]; ids int (..., T)."""
    y = table[ids.long()]
    spec = LayerSpec("embed", param_path=param_path,
                     meta=(("vocab", table.shape[0]),))
    return tape.inject(name, y, spec, {"ids": ids})


def scale(tape: Tape, name: str, x, g, *, param_path: str):
    """y = x * g with g matching x's trailing dims (a norm's gain)."""
    y = x * g.to(x.dtype)
    spec = LayerSpec("scale", param_path=param_path, meta=(("gdim", g.dim()),))
    return tape.inject(name, y, spec, {"x": x})


def bias(tape: Tape, name: str, x, b, *, param_path: str):
    """y = x + b with b matching x's trailing dims."""
    y = x + b.to(x.dtype)
    spec = LayerSpec("bias", param_path=param_path, meta=(("bdim", b.dim()),))
    return tape.inject(name, y, spec, {})


def conv1d_depthwise(tape: Tape, name: str, x, w, *, param_path: str):
    """Causal depthwise conv: x (B, T, C), w (K, C);
    y[b, t, c] = sum_k w[k, c] * xpad[b, t + k, c], xpad left-padded by K-1."""
    k = w.shape[0]
    xpad = F.pad(x, (0, 0, k - 1, 0))
    y = sum(xpad[:, i:i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k))
    spec = LayerSpec("conv1d", param_path=param_path, meta=(("width", k),))
    return tape.inject(name, y, spec, {"x": x})


# ---------------------------------------------------------------------------
# shape normalisation for the analytic companions
# ---------------------------------------------------------------------------

def _fold(spec: LayerSpec, rec: Dict, dY):
    """Normalise (record, dY) for the companions, as the reference's
    ``_fold`` does.  On entry each leading stack axis is a list level (or a
    tensor axis), outermost first.  A 'uses' axis (one parameter re-used
    each step) is stacked and moved after the batch axis, where the
    companions treat it as an extra token axis (exact cross-use inner
    products).  'layers' axes stay as they are, nested lists of per-layer
    tensors (or leading tensor axes): norms add over them and grads stack
    on them.  Returns (rec, dY, number of layer axes)."""
    stack = spec.stack
    use_ax = [i for i, s in enumerate(stack) if s == "uses"]
    if not use_ax:
        return rec, dY, len(stack)
    layer_ax = [i for i, s in enumerate(stack) if s == "layers"]
    n = len(stack)

    def fix(a):
        a = _stacked(a)
        return a.permute(layer_ax + [n] + use_ax
                         + list(range(n + 1, a.dim())))

    return {k: fix(v) for k, v in rec.items()}, fix(dY), len(layer_ax)


def _stacked(a):
    """Nested lists of tensors as one tensor, a leading axis per level."""
    if isinstance(a, (list, tuple)):
        return torch.stack([_stacked(v) for v in a])
    return a


def _blocks(a, n_layer_axes: int):
    """The tensors below the list levels of ``n_layer_axes`` leading layer
    axes, outermost first, as one flat list; each keeps the layer axes that
    are tensor axes (a ``dense_stacked`` record's E) in front."""
    if n_layer_axes == 0 or not isinstance(a, (list, tuple)):
        return [a]
    return [x for sub in a for x in _blocks(sub, n_layer_axes - 1)]


def _list_depth(a, n_layer_axes: int) -> int:
    """How many of ``n_layer_axes`` leading layer axes are list levels."""
    depth = 0
    while depth < n_layer_axes and isinstance(a, (list, tuple)):
        a, depth = a[0], depth + 1
    return depth


def _lead_shape(a, n_layer_axes: int):
    """The extents of ``n_layer_axes`` leading layer axes."""
    if n_layer_axes == 0:
        return ()
    return (len(a),) + _lead_shape(a[0], n_layer_axes - 1)


def _as_btd(a):
    """Collapse (B, T..., d) -> (B, T, d); (B, d) -> (B, 1, d)."""
    if a.dim() == 2:
        return a[:, None, :]
    return a.reshape(a.shape[0], -1, a.shape[-1])


def _map_layers(fn, args, n_layer_axes: int):
    """Apply ``fn`` to each layer of the layer axes in turn (one layer's
    temporaries live at a time) and sum the (B,) results over all of
    them.  Layer axes that are tensor axes (a ``dense_stacked`` record's
    E experts) are folded into the batch axis of one call: ``fn`` is
    row-wise, so each expert's rows get that expert's arithmetic, and the
    sum still runs over one (B,) row per layer."""
    if n_layer_axes == 0:
        return fn(*args)
    k = n_layer_axes - _list_depth(args[0], n_layer_axes)
    rows = []
    for a in zip(*(_blocks(x, n_layer_axes) for x in args)):
        out = fn(*(t.reshape((-1,) + t.shape[k + 1:]) for t in a))
        rows.append(out.reshape(math.prod(a[0].shape[:k]), -1))
    return torch.cat(rows).sum(dim=0)


def _sum_except(a, keep_trailing: int, start: int = 1):
    """Sum ``a`` over axes ``start .. a.dim() - keep_trailing - 1`` (none:
    ``a`` itself — PyTorch would read an empty ``dim`` as every axis)."""
    red = tuple(range(start, a.dim() - keep_trailing))
    return a.sum(dim=red) if red else a


# ---------------------------------------------------------------------------
# per-example squared gradient norms (ghost clipping)
# ---------------------------------------------------------------------------

def _sq_norm_dense_one(x, dy, has_bias):
    """x (B, T, i), dy (B, T, o) -> (B,) squared norm of the per-example
    W (+ b) grads.  The Mixed-Ghost rule (Bu et al., 2022): the ghost path
    (O(T^2 d)) when T^2 <= din*dout and T > 1, else the direct path through
    the :func:`~repro_torch.kernels.ghost_norm.ghost_norm_dense` kernel,
    which takes the records in their storage dtype and upcasts itself."""
    x = _as_btd(x)
    dy = _as_btd(dy)
    _, T, di = x.shape
    do = dy.shape[-1]
    use_ghost = (T * T <= di * do) if _FORCE_PATH is None \
        else (_FORCE_PATH == "ghost")
    df = dy.float()
    if use_ghost and T > 1:
        xf = x.float()
        gx = torch.bmm(xf, xf.transpose(1, 2))
        gd = torch.bmm(df, df.transpose(1, 2))
        nw = (gx * gd).sum(dim=(1, 2))
    else:
        nw = ghost_norm_dense(x.contiguous(), dy.contiguous())
    if has_bias:
        gb = df.sum(dim=1)
        nw = nw + (gb * gb).sum(dim=-1)
    return nw


def _sq_norm_embed_one(ids, dy):
    """ids (B, T...), dy (B, T..., d): the ghost trick on the one-hot
    design matrix."""
    ids = ids.reshape(ids.shape[0], -1)
    df = _as_btd(dy).float()
    same = (ids[:, :, None] == ids[:, None, :]).float()
    gd = torch.bmm(df, df.transpose(1, 2))
    return (same * gd).sum(dim=(1, 2))


def _sq_norm_scale_one(x, dy, gdim):
    """grad_g[b] = the sum over non-parameter axes of x * dy."""
    g = _sum_except(x.float() * dy.float(), gdim)
    return (g.reshape(g.shape[0], -1) ** 2).sum(dim=-1)


def _sq_norm_bias_one(dy, bdim):
    g = _sum_except(dy.float(), bdim)
    return (g.reshape(g.shape[0], -1) ** 2).sum(dim=-1)


def _pe_grad_conv1d(x, dy, k):
    """Per-example conv grads (B, K, C); K is tiny, so this is cheap."""
    xpad = F.pad(x, (0, 0, k - 1, 0)).float()
    T = x.shape[1]
    df = dy.float()
    return torch.stack([torch.einsum("btc,btc->bc", xpad[:, i:i + T], df)
                        for i in range(k)], dim=1)


def per_example_sq_norm(spec: LayerSpec, rec: Dict, dY) -> torch.Tensor:
    rec, dY, nl = _fold(spec, rec, dY)
    if spec.kind == "dense":
        hb = spec.get("has_bias", False)
        return _map_layers(lambda x, d: _sq_norm_dense_one(x, d, hb),
                           (rec["x"], dY), nl)
    if spec.kind == "embed":
        return _map_layers(_sq_norm_embed_one, (rec["ids"], dY), nl)
    if spec.kind == "scale":
        gd = spec.get("gdim", 1)
        return _map_layers(lambda x, d: _sq_norm_scale_one(x, d, gd),
                           (rec["x"], dY), nl)
    if spec.kind == "bias":
        bd = spec.get("bdim", 1)
        return _map_layers(lambda d: _sq_norm_bias_one(d, bd), (dY,), nl)
    if spec.kind == "conv1d":
        k = spec.get("width")

        def f(x, d):
            g = _pe_grad_conv1d(x, d, k)
            return (g.reshape(g.shape[0], -1) ** 2).sum(dim=-1)
        return _map_layers(f, (rec["x"], dY), nl)
    raise ValueError(spec.kind)


# ---------------------------------------------------------------------------
# book-keeping: clipped summed grads straight from the tape
# ---------------------------------------------------------------------------

def _coef_mul(a, coef, n_lead: int = 0):
    """Multiply (lead..., B, ...) by the per-example coef (B,), behind
    ``n_lead`` leading axes."""
    return a * coef.reshape((1,) * n_lead + (-1,)
                            + (1,) * (a.dim() - n_lead - 1)).to(a.dtype)


def bk_grads(spec: LayerSpec, rec: Dict, dY, coef) -> Dict[str, torch.Tensor]:
    """sum_b coef_b * per-example-grad_b, without per-example parameter
    gradients.  Keys are ``<param_path>`` (dense: ``.w`` and ``.b``); on a
    layer stack each grad gains the leading layer axes ((6, 6, ...) for
    two nested stacks of 6).  The sums over examples are products and
    reductions, not the strict fold of ``masked_pe``, so the result agrees
    with it to f32 rounding."""
    rec, dY, nl = _fold(spec, rec, dY)
    if nl == 0:
        return _bk_grads_one(spec, rec, dY, coef)
    k = nl - _list_depth(dY, nl)
    per = [_bk_grads_block(spec, dict(zip(rec, r)), d, coef, k)
           for *r, d in zip(*(_blocks(v, nl) for v in rec.values()),
                            _blocks(dY, nl))]
    lead = _lead_shape(dY, nl)
    return {n: torch.stack([p[n] for p in per]).reshape(
        lead + per[0][n].shape[k:]) for n in per[0]}


def _bk_grads_block(spec: LayerSpec, rec: Dict, dY, coef, k: int):
    """:func:`bk_grads` of one block whose ``k`` leading layer axes are
    tensor axes (the experts of ``dense_stacked``, or the 'layers' axes
    that :func:`_fold` stacks when it folds a 'uses' axis): a dense without
    bias takes one batched product over them, any other record one layer
    at a time."""
    if k == 0:
        return _bk_grads_one(spec, rec, dY, coef)
    if spec.kind == "dense" and not spec.get("has_bias", False):
        lead = dY.shape[:k]
        x = rec["x"].float().reshape((-1,) + rec["x"].shape[k:])
        d = _coef_mul(dY.float().reshape((-1,) + dY.shape[k:]), coef, 1)
        xb = x.reshape(x.shape[0], -1, x.shape[-1])
        db = d.reshape(d.shape[0], -1, d.shape[-1])
        return {spec.param_path + ".w": torch.bmm(
            xb.transpose(1, 2), db).reshape(lead + (xb.shape[-1],
                                                    db.shape[-1]))}
    per = [_bk_grads_block(spec, dict(zip(rec, r)), d, coef, k - 1)
           for *r, d in zip(*rec.values(), dY)]
    return {n: torch.stack([p[n] for p in per]) for n in per[0]}


def _add_rows(n_rows: int, ids, rows):
    """(n_rows, d) f32 zeros with each of ``rows`` added into row
    ``ids[i]``, a repeated id's rows in one order on every run (what a
    bitwise resume needs).  The op differs by device for that: on the CPU
    ``index_add_`` adds in position order (an accumulating ``index_put_``
    varies there); on the card ``index_add_`` adds with atomics, in the
    order the schedule gives, where an accumulating ``index_put_`` sorts
    the ids and adds each one's rows in turn (``chip_smoke.py`` reruns
    it)."""
    out = torch.zeros(n_rows, rows.shape[-1], dtype=torch.float32,
                      device=rows.device)
    if rows.is_cuda:
        return out.index_put_((ids,), rows, accumulate=True)
    return out.index_add_(0, ids, rows)


def _bk_grads_one(spec: LayerSpec, rec: Dict, dY, coef):
    """:func:`bk_grads` of one layer: ``rec`` and ``dY`` lead with the batch
    axis."""
    dYc = _coef_mul(dY.float(), coef)
    if spec.kind == "dense":
        x = rec["x"].float()
        xb = x.reshape(x.shape[0], -1, x.shape[-1])
        db = dYc.reshape(dYc.shape[0], -1, dYc.shape[-1])
        out = {spec.param_path + ".w": torch.einsum("bti,bto->io", xb, db)}
        if spec.get("has_bias", False):
            out[spec.param_path + ".b"] = db.sum(dim=(0, 1))
        return out
    if spec.kind == "embed":
        return {spec.param_path: _add_rows(spec.get("vocab"),
                                           rec["ids"].reshape(-1).long(),
                                           dYc.reshape(-1, dYc.shape[-1]))}
    if spec.kind == "scale":
        return {spec.param_path: _sum_except(rec["x"].float() * dYc,
                                             spec.get("gdim", 1), start=0)}
    if spec.kind == "bias":
        return {spec.param_path: _sum_except(dYc, spec.get("bdim", 1),
                                             start=0)}
    if spec.kind == "conv1d":
        return {spec.param_path: _pe_grad_conv1d(
            rec["x"], dYc, spec.get("width")).sum(dim=0)}
    raise ValueError(spec.kind)
