"""Fused DP noise + SGD(+momentum) apply: the Hopper kernel
(``csrc/noisy_update.cu``), its plain PyTorch version, and
``tree_noisy_update``, which applies it to every leaf of a step in ONE
launch.

Replaces the reference package's TPU kernel ``noisy_sgd_update``
(``kernels/noisy_update.py``) and its pytree glue
(``kernels/ops.py:tree_noisy_update``).  Over one flat f32 leaf::

    g = (acc + sigma_c * z) / L;   m <- mu * m + g;   p <- p - lr * m

The kernel updates ``p`` and ``m`` IN PLACE (the reference returns new
arrays; in place saves a params-sized buffer per step).  Noise comes from an
operand, from the in-kernel Threefry-2x32 stream (the main path), or not at
all (the non-private step).

**One launch per step.**  On the card :func:`tree_noisy_update` hands the
kernel a leaf table (:func:`build_leaf_table`): per leaf its param address,
its offset into the flat accumulator, momentum and noise buffers, its size,
its index, its alignment and its first work item.  The table is built once
per view and per set of parameter tensors and kept on the device
(:func:`device_leaf_table`); a replaced parameter tensor rebuilds it.  Each
block of the launch takes one work item, :data:`CHUNK` elements of one leaf.
The CPU keeps the plain per-leaf loop.

**The noise alone.**  :func:`tree_noise` launches the kernel's noise-only
body over the same table: the flat N(0,1) buffer the fused update would
add, for the unfused update path (AdamW, Nesterov, ``fuse=False``).

**Per-step seeds.**  The reference draws its noise key with
``jax.random.split``; the port cannot reproduce that and does not try.  A
session's state key is two uint32 words; step ``k``'s two seed words are
``threefry2x32(key, (k mod 2^32, k >> 32))`` (:func:`step_seeds`), a pure
function of the key and the ABSOLUTE step, so a rerun draws the same noise
bit for bit.  Leaf ``i`` then uses the seed words plus ``i`` (both words),
and the counter of element ``j`` of the leaf is ``(j, 0)``, as the
reference's ``ops.tree_noisy_update`` and ``_tf_noise`` do.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build

_M32 = 0xFFFFFFFF
_TF_ROTS = (13, 15, 26, 6, 17, 29, 16, 24)
_TF_PARITY = 0x1BD11BDA
_TWO_PI = 6.283185307179586
_NOISE_NONE, _NOISE_OPERAND, _NOISE_THREEFRY = 0, 1, 2
# elements per work item of the launch: csrc/noisy_update.cu's kChunk
CHUNK = 2048
# 16-byte vectors of four f32
VEC = 4


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, as the reference's ``threefry2x32``.

    Works on Python ints and on int64 tensors holding uint32 values (every
    step is masked to 32 bits: PyTorch's uint32 has few ops on the CPU)."""
    k0, k1 = int(k0) & _M32, int(k1) & _M32
    ks = (k0, k1, k0 ^ k1 ^ _TF_PARITY)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for r in range(5):
        for i in range(4):
            rot = _TF_ROTS[(r % 2) * 4 + i]
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << rot) | (x1 >> (32 - rot))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(r + 1) % 3]) & _M32
        x1 = (x1 + ks[(r + 2) % 3] + (r + 1)) & _M32
    return x0, x1


def bits_to_normal(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Box–Muller: two uint32 bit tensors (held in int64) -> one standard
    normal f32 tensor, the reference's ``bits_to_normal`` op for op."""
    u1 = (b1 >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    u2 = (b2 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI * u2)


def threefry_normal(seed: Tuple[int, int], n: int, device) -> torch.Tensor:
    """The plain version of the kernel's noise: N(0,1) for counters
    ``(0..n-1, 0)`` under ``seed``."""
    c0 = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(seed[0], seed[1], c0, torch.zeros_like(c0))
    return bits_to_normal(b1, b2)


def step_seeds(key: Tuple[int, int], step: int) -> Tuple[int, int]:
    """Step ``step``'s two seed words from the state key (module doc)."""
    return threefry2x32(key[0], key[1], int(step) & _M32, int(step) >> 32)


def leaf_seed(seeds: Tuple[int, int], i: int) -> Tuple[int, int]:
    """Leaf ``i``'s key: the step's seed words plus ``i``, both words."""
    return (seeds[0] + i) & _M32, (seeds[1] + i) & _M32


def update_scalars(sigma_c, expected_batch, lr, momentum):
    """The kernel's f32 scalars ``(sigma_c, 1/L, lr, mu)``; ``1/L`` is taken
    in double and rounded once, as the reference does."""
    return tuple(float(np.float32(x)) for x in
                 (sigma_c, 1.0 / float(expected_batch), lr, momentum))


def noisy_sgd_update_plain(p, acc, z, sc, inv_l, lr, m=None, mu=0.0):
    """Plain PyTorch version, in place on ``p`` (and ``m``): the kernel's
    arithmetic, one rounding per op in the same order."""
    a = acc if z is None else acc + z * sc
    g = a * inv_l
    if m is None:
        p.sub_(g * lr)
    else:
        m.mul_(mu).add_(g)
        p.sub_(m * lr)
    return p, m


def _check_flat(name, t, n, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, params on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def noisy_sgd_update(params, acc, noise, sigma_c, expected_batch, lr, *,
                     momentum_buf=None, momentum=0.0,
                     seed: Optional[Tuple[int, int]] = None):
    """Flat f32 leaf ``params`` (n,) <- p - lr * ((acc + sigma_c z) / L)
    [+ momentum], in place; returns ``(params, momentum_buf)``.

    ``noise`` is the N(0,1) operand; pass ``noise=None, seed=(w0, w1)`` to
    draw it in the kernel, or neither for the noise-free step.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (or raises).
    """
    n = params.shape[0] if params.dim() == 1 else -1
    dev = params.device
    _check_flat("params", params, n, dev)
    _check_flat("acc", acc, n, dev)
    if noise is not None:
        if seed is not None:
            raise ValueError("pass noise or seed, not both")
        _check_flat("noise", noise, n, dev)
    if momentum_buf is not None:
        _check_flat("momentum_buf", momentum_buf, n, dev)
    sc, inv_l, lr, mu = update_scalars(sigma_c, expected_batch, lr, momentum)
    if dev.type == "cpu":
        z = (threefry_normal(seed, n, dev) if seed is not None else noise)
        return noisy_sgd_update_plain(params, acc, z, sc, inv_l, lr,
                                      momentum_buf, mu)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _build.require_hopper(dev)
    lib = _library()
    kind = (_NOISE_OPERAND if noise is not None else
            _NOISE_THREEFRY if seed is not None else _NOISE_NONE)
    k0, k1 = (int(seed[0]) & _M32, int(seed[1]) & _M32) if seed else (0, 0)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.noisy_sgd_update_launch(
            params.data_ptr(), acc.data_ptr(), ptr(noise), ptr(momentum_buf),
            n, kind, k0, k1, sc, inv_l, lr, mu, stream)
    _build.check(lib, rc, "noisy_sgd_update")
    noisy_sgd_update.launches += 1
    return params, momentum_buf


noisy_sgd_update.launches = 0


def threefry_bits(seed: Tuple[int, int], n: int, device):
    """The kernel's Threefry bits for counters ``(0..n-1, 0)``, as two int64
    tensors: the plain version on the CPU, the kernel's own device function
    on a CUDA device — so the in-kernel stream can be held bitwise against
    :func:`threefry2x32`."""
    device = torch.device(device)
    if device.type == "cpu":
        c0 = torch.arange(n, dtype=torch.int64)
        return threefry2x32(seed[0], seed[1], c0, torch.zeros_like(c0))
    _build.require_hopper(device)
    lib = _library()
    o0 = torch.empty(n, dtype=torch.int32, device=device)
    o1 = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.threefry_bits_launch(int(seed[0]) & _M32,
                                      int(seed[1]) & _M32, n,
                                      o0.data_ptr(), o1.data_ptr(), stream)
    _build.check(lib, rc, "threefry_bits")
    threefry_bits.launches += 1
    return o0.to(torch.int64) & _M32, o1.to(torch.int64) & _M32


threefry_bits.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("noisy_update")
    if not getattr(lib, "_typed", False):
        P, I, I64, U32, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                             ctypes.c_uint32, ctypes.c_float)
        lib.noisy_sgd_update_launch.argtypes = [P, P, P, P, I64, I, U32, U32,
                                                F, F, F, F, P]
        lib.noisy_sgd_update_launch.restype = I
        lib.noisy_tree_update_launch.argtypes = [P, I, I64, P, P, P, I, I,
                                                 U32, U32, F, F, F, F, P]
        lib.noisy_tree_update_launch.restype = I
        lib.noise_tree_launch.argtypes = [P, I, I64, P, I, U32, U32, I64,
                                          I64, P]
        lib.noise_tree_launch.restype = I
        lib.threefry_bits_launch.argtypes = [U32, U32, I64, P, P, P]
        lib.threefry_bits_launch.restype = I
        lib.noisy_update_chunk.restype = I64
        if lib.noisy_update_chunk() != CHUNK:
            raise RuntimeError(f"csrc/noisy_update.cu chunks by "
                               f"{lib.noisy_update_chunk()}, the wrapper by "
                               f"{CHUNK}")
        lib._typed = True
    return lib


# the leaf table's columns (one int64 row per non-empty leaf)
TABLE_COLUMNS = ("ptr", "offset", "size", "leaf", "head", "item0")


def build_leaf_table(view, ptrs) -> Tuple[np.ndarray, int]:
    """The kernel's leaf table for ``view`` with param ``i`` at address
    ``ptrs[i]``: an int64 array with one row per non-empty leaf (columns
    :data:`TABLE_COLUMNS`) and the launch's number of work items.

    ``head`` is the number of elements before the leaf's first 16-byte
    vector, counted from the flat offset (the flat buffers are 16-byte
    aligned), or -1 when the param sits at another phase of 16 bytes and
    the leaf goes element by element.  A leaf's work items cover its vector
    span (:data:`CHUNK` elements each, at least one); the head goes with the
    first, the tail (< 4 elements) with the last."""
    rows, items = [], 0
    for i, (o, n) in enumerate(zip(view.offsets, view.sizes)):
        if n == 0:
            continue
        head = min((-o) % VEC, n)
        if (ptrs[i] + 4 * head) % (4 * VEC):
            head = -1
        span = n if head < 0 else (n - head) // VEC * VEC
        rows.append((ptrs[i], o, n, i, head, items))
        items += max(1, -(-span // CHUNK))
    return np.array(rows, dtype=np.int64).reshape(-1, 6), items


def leaf_table_elements(table: np.ndarray, items: int,
                        vec_ok: bool = True):
    """The plain model of the kernel's walk over ``table``: for each of the
    ``items`` work items, the elements its block updates, as (item, leaf,
    j, flat offset, in a vector) tuples with ``j`` the index within the
    leaf.  ``vec_ok`` false (a flat buffer off 16 bytes): the same elements,
    none in a vector."""
    starts = table[:, 5]
    for item in range(items):
        r = int(np.searchsorted(starts, item, side="right")) - 1
        _, o, n, leaf, head, item0 = (int(v) for v in table[r])
        c = item - item0
        if head < 0:
            js = [(j, False) for j in range(c * CHUNK, min(n, (c + 1) * CHUNK))]
        else:
            vend = head + (n - head) // VEC * VEC
            v0 = head + c * CHUNK
            js = [(j, vec_ok) for j in range(v0, min(v0 + CHUNK, vend))]
            if c == 0:
                js += [(j, False) for j in range(head)]
            if v0 + CHUNK >= vend:
                js += [(j, False) for j in range(vend, n)]
        for j, vec in js:
            yield item, leaf, j, o + j, vec


_TABLES: Dict[tuple, Tuple[torch.Tensor, int, int]] = {}
_TABLES_KEPT = 8


def device_leaf_table(view, ptrs, device) -> Tuple[torch.Tensor, int, int]:
    """(the leaf table on ``device``, its rows, the work items), cached per
    view, device and tuple of param addresses: a replaced param tensor
    (another address) builds a new table."""
    key = (view, device, ptrs)
    hit = _TABLES.get(key)
    if hit is None:
        table, items = build_leaf_table(view, ptrs)
        if len(_TABLES) >= _TABLES_KEPT:
            _TABLES.clear()
        hit = (torch.from_numpy(table).to(device), len(table), items)
        _TABLES[key] = hit
    return hit


def tree_noisy_update(params: Dict[str, torch.Tensor], grad_acc, seeds,
                      sigma_c, expected_batch, lr, *, view,
                      momentum_buf=None, momentum=0.0, noise=None):
    """The fused DP apply over every leaf, against its offset range of the
    flat accumulator.  Params (and the flat momentum buffer) are updated in
    place.  On the card: ONE launch over the device leaf table
    (:func:`device_leaf_table`), counted in ``noisy_sgd_update.launches``;
    the operands are checked once per call.  On the CPU: the plain version,
    leaf by leaf.

    ``seeds`` = the step's two seed words (in-kernel noise, leaf ``i`` at
    ``seeds + i``); ``noise`` = a flat N(0,1) operand in the view's layout
    instead; neither = the noise-free step (``sigma_c`` ignored)."""
    dev = grad_acc.device
    if dev.type == "cpu":
        for i, name in enumerate(view.names):
            o, n = view.offsets[i], view.sizes[i]
            seg = lambda t: None if t is None else t[o:o + n]
            seed = leaf_seed(seeds, i) if seeds is not None and noise is None \
                else None
            noisy_sgd_update(params[name].view(-1), grad_acc[o:o + n],
                             seg(noise), sigma_c, expected_batch, lr,
                             momentum_buf=seg(momentum_buf),
                             momentum=momentum, seed=seed)
        return params, momentum_buf
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    flats = {nm: t for nm, t in (("grad_acc", grad_acc), ("noise", noise),
                                 ("momentum_buf", momentum_buf))
             if t is not None}
    for nm, t in flats.items():
        _check_flat(nm, t, view.total, dev)
    leaves = [params[nm] for nm in view.names]
    for nm, t, n in zip(view.names, leaves, view.sizes):
        if (t.dtype != torch.float32 or t.device != dev or t.numel() != n
                or not t.is_contiguous()):
            raise ValueError(f"param {nm} must be a contiguous float32 "
                             f"tensor of {n} elements on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _build.require_hopper(dev)
    lib = _library()
    table, n_rows, items = device_leaf_table(
        view, tuple(t.data_ptr() for t in leaves), dev)
    if n_rows == 0:                      # no element to update
        return params, momentum_buf
    sc, inv_l, lr, mu = update_scalars(sigma_c, expected_batch, lr, momentum)
    kind = (_NOISE_OPERAND if noise is not None else
            _NOISE_THREEFRY if seeds is not None else _NOISE_NONE)
    k0, k1 = ((int(seeds[0]) & _M32, int(seeds[1]) & _M32)
              if kind == _NOISE_THREEFRY else (0, 0))
    vec_ok = int(all(t.data_ptr() % 16 == 0 for t in flats.values()))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.noisy_tree_update_launch(
            table.data_ptr(), n_rows, items, grad_acc.data_ptr(), ptr(noise),
            ptr(momentum_buf), vec_ok, kind, k0, k1, sc, inv_l, lr, mu,
            stream)
    _build.check(lib, rc, "tree_noisy_update")
    noisy_sgd_update.launches += 1
    return params, momentum_buf


def tree_noise(params: Dict[str, torch.Tensor], seeds, *, view,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step's noise alone, as a flat f32 N(0,1) buffer in ``view``'s
    layout: leaf ``i``'s elements are what :func:`tree_noisy_update` draws
    in the kernel for it (:func:`threefry_normal` at ``leaf_seed(seeds,
    i)``), the alignment tail is zero.  The unfused update path adds this
    buffer, so it and the fused kernel draw one stream.

    On the card: ONE launch of the noise-only body over the device leaf
    table of ``params`` (:func:`device_leaf_table`), which also zeroes the
    tail, counted in ``tree_noise.launches``; it raises, never falls
    back.  On the CPU: the
    plain version, leaf by leaf.  ``out`` (a flat f32 buffer of
    ``view.total``) is written and returned instead of a new one."""
    dev = params[view.names[0]].device if view.names else torch.device("cpu")
    if out is None:
        out = torch.empty(view.total, dtype=torch.float32, device=dev)
    _check_flat("out", out, view.total, dev)
    if dev.type == "cpu":
        out[view.n_params:].zero_()
        for i in range(len(view.names)):
            o, n = view.offsets[i], view.sizes[i]
            out[o:o + n] = threefry_normal(leaf_seed(seeds, i), n, dev)
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    leaves = [params[nm] for nm in view.names]
    _build.require_hopper(dev)
    lib = _library()
    table, n_rows, items = device_leaf_table(
        view, tuple(t.data_ptr() for t in leaves), dev)
    if n_rows == 0:
        out.zero_()
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.noise_tree_launch(
            table.data_ptr(), n_rows, items, out.data_ptr(),
            int(out.data_ptr() % 16 == 0), int(seeds[0]) & _M32,
            int(seeds[1]) & _M32, view.n_params, view.total, stream)
    _build.check(lib, rc, "tree_noise")
    tree_noise.launches += 1
    return out


tree_noise.launches = 0
