"""DP layer primitives of the port, as in the reference package's
``core/layers.py``.

Every parameterised op of the port's models goes through one of five
primitives:

    dense            y = x @ W (+ b)
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


def _layers(a, n_layer_axes: int):
    """The per-layer entries of ``n_layer_axes`` leading layer axes (list
    levels or tensor axes), outermost first, as one flat list."""
    if n_layer_axes == 0:
        return [a]
    return [x for sub in a for x in _layers(sub, n_layer_axes - 1)]


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
    them."""
    if n_layer_axes == 0:
        return fn(*args)
    per = zip(*(_layers(a, n_layer_axes) for a in args))
    return torch.stack([fn(*a) for a in per]).sum(dim=0)


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

def _coef_mul(a, coef):
    """Multiply (B, ...) by the per-example coef (B,)."""
    return a * coef.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)


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
    per = [_bk_grads_one(spec, dict(zip(rec, r)), d, coef)
           for *r, d in zip(*(_layers(v, nl) for v in rec.values()),
                            _layers(dY, nl))]
    lead = _lead_shape(dY, nl)
    return {k: torch.stack([p[k] for p in per]).reshape(
        lead + per[0][k].shape) for k in per[0]}


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
        d = dYc.shape[-1]
        g = torch.zeros(spec.get("vocab"), d, dtype=torch.float32,
                        device=dYc.device).index_add_(
            0, rec["ids"].reshape(-1).long(), dYc.reshape(-1, d))
        return {spec.param_path: g}
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
