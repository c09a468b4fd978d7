"""Clipped masked sums of per-example gradient rows: the Hopper kernels
(``csrc/clip_accum.cu``), their plain PyTorch versions, and the engines'
wrappers ``tree_clip_accum`` (``masked_fused``) and ``flat_clip_accum``
(``masked_fused_stream``).

Replaces the reference package's TPU kernels (``kernels/clip_accum.py``)::

    clip_accum_inplace:  acc[d] += sum_b coef_b * g[b, d]
    clip_accum:          out[d]  = sum_b coef_b * g[b, d]
    coef_b = mask_b * min(1, C / max(norm_b, 1e-12))

each as a strict left fold over ``b``, from the carry or from +0 (the
reference's ``_fold_rows``), with no fused multiply-add: the result is then
the same for every tile size and bitwise equal to the ``masked_pe``
oracle's fold.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

# the kernel keeps the m coefficients in shared memory (48 KB without opt-in)
MAX_TILE = 12288
# elements per vector of the kernel (its kVec): a float4 of acc and of f32
# rows, 8 bytes of bf16 rows
VEC = 4


def clip_coefs(norms, mask, clip_norm):
    """mask * min(1, C / max(norm, 1e-12)), each op rounded once (an
    explicit division: ``C / tensor`` in PyTorch multiplies by the
    reciprocal, which rounds differently)."""
    c = torch.full_like(norms, float(clip_norm))
    return mask * torch.clamp_max(torch.div(c, torch.clamp_min(norms, 1e-12)),
                                  1.0)


def clip_accum_inplace_plain(acc, grads, norms, mask, clip_norm):
    """Plain PyTorch version, in place on ``acc``: the same fold."""
    coef = clip_coefs(norms, mask, clip_norm)
    for b in range(grads.shape[0]):
        acc.add_(grads[b].float() * coef[b])
    return acc


def clip_accum_plain(grads, norms, mask, clip_norm):
    """Plain PyTorch version of the resident form: the same fold from +0
    (the reference's ``clip_accum_ref``)."""
    coef = clip_coefs(norms, mask, clip_norm)
    out = torch.zeros(grads.shape[1], dtype=torch.float32,
                      device=grads.device)
    for b in range(grads.shape[0]):
        out.add_(grads[b].float() * coef[b])
    return out


def _check_operands(grads, norms, mask, acc=None) -> None:
    """Raise on what the kernels do not take."""
    if grads.dim() != 2:
        raise ValueError(f"grads must be (m, D), got {tuple(grads.shape)}")
    m, d = grads.shape
    dev = grads.device
    operands = [("grads", grads, (m, d), (torch.float32, torch.bfloat16)),
                ("norms", norms, (m,), (torch.float32,)),
                ("mask", mask, (m,), (torch.float32,))]
    if acc is not None:
        operands.insert(0, ("acc", acc, (d,), (torch.float32,)))
    for name, t, shape, dtypes in operands:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, grads on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)} (pad the tile to the "
                             f"accumulator layout before the call)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and m > MAX_TILE:
        raise ValueError(f"{m} rows exceed the kernel's {MAX_TILE}")


def clip_split(out_addr: int, g_addr: int, g_itemsize: int, m: int,
               d: int) -> Tuple[int, int, int]:
    """How the kernel walks a call: ``(head, vectors, tail)``, with
    ``head + VEC * vectors + tail == d``.  Elements ``[0, head)`` and the
    last ``tail`` go one by one, the rest ``VEC`` at a time, where the
    output (``acc`` or ``out``, f32, at byte address ``out_addr``) and
    every row of ``g`` (at ``g_addr``, ``g_itemsize`` bytes an element,
    rows ``d`` apart) start a vector on a ``VEC * itemsize`` boundary.
    Every row is in phase with the output when ``m`` is 1 or ``d`` is a
    multiple of ``VEC``; otherwise, or when the output and ``g`` sit at
    different phases, the split is ``(d, 0, 0)``: the whole call goes one
    element at a time, in the same kernel."""
    head = (-(out_addr // 4)) % VEC
    in_phase = ((g_addr + head * g_itemsize) % (VEC * g_itemsize) == 0
                and (m <= 1 or d % VEC == 0))
    if not in_phase or head >= d:
        return d, 0, 0
    vectors = (d - head) // VEC
    return head, vectors, d - head - VEC * vectors


def _launch(entry: str, out, grads, norms, mask, clip_norm) -> None:
    dev = grads.device
    _build.require_hopper(dev)
    lib = _library()
    m, d = grads.shape
    head, vectors, _ = clip_split(out.data_ptr(), grads.data_ptr(),
                                  grads.element_size(), m, d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            out.data_ptr(), grads.data_ptr(),
            int(grads.dtype == torch.bfloat16), norms.data_ptr(),
            mask.data_ptr(), float(clip_norm), m, d, head, vectors, stream)
    _build.check(lib, rc, entry)


def clip_accum_inplace(acc, grads, norms, mask, clip_norm):
    """acc (D,) f32 += sum_b mask_b min(1, C/norm_b) grads[b], in place.

    ``grads`` is an (m, D) tile, f32 or bf16 (upcast in the kernel),
    already in the accumulator's layout; ``norms`` and ``mask`` are (m,)
    f32.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    _check_operands(grads, norms, mask, acc)
    if acc.device.type == "cpu":
        return clip_accum_inplace_plain(acc, grads, norms, mask, clip_norm)
    _launch("clip_accum_inplace_launch", acc, grads, norms, mask, clip_norm)
    clip_accum_inplace.launches += 1
    return acc


clip_accum_inplace.launches = 0


def clip_accum(grads, norms, mask, clip_norm):
    """(D,) f32 = sum_b mask_b min(1, C/norm_b) grads[b], folded from +0.

    ``grads`` is the resident (B, D) per-example matrix, f32 or bf16
    (upcast in the kernel); ``norms`` and ``mask`` are (B,) f32.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises)."""
    _check_operands(grads, norms, mask)
    if grads.device.type == "cpu":
        return clip_accum_plain(grads, norms, mask, clip_norm)
    out = torch.empty(grads.shape[1], dtype=torch.float32,
                      device=grads.device)
    _launch("clip_accum_launch", out, grads, norms, mask, clip_norm)
    clip_accum.launches += 1
    return out


clip_accum.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("clip_accum")
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        for entry in (lib.clip_accum_inplace_launch, lib.clip_accum_launch):
            entry.argtypes = [P, P, ctypes.c_int, P, P, ctypes.c_float,
                              ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64, P]
            entry.restype = ctypes.c_int
        lib._typed = True
    return lib


def tree_clip_accum(grads, norms, mask, clip_norm, view):
    """``masked_fused``'s accumulate: the per-example grads ``{path: (B,
    *shape)}`` (consumed: each leaf is dropped once copied) as ONE (B, D)
    matrix in ``view``'s flat layout (zero over the alignment tail, in the
    leaves' storage dtype), one :func:`clip_accum` launch, and the (D,)
    result unflattened into ``{path: view}``."""
    B = int(norms.shape[0])
    dtype = (torch.bfloat16 if all(g.dtype == torch.bfloat16
                                   for g in grads.values())
             else torch.float32)
    flat = torch.empty(B, view.total, dtype=dtype, device=norms.device)
    for i, name in enumerate(view.names):
        o = view.offsets[i]
        flat[:, o:o + view.sizes[i]].copy_(grads.pop(name).reshape(B, -1))
    flat[:, view.n_params:].zero_()
    return view.unflatten(clip_accum(flat, norms, mask, clip_norm))


def flat_clip_accum(acc, tile_grads, norms, mask, clip_norm):
    """Streaming accumulate: ``acc (D,) += sum_b coef_b tile_grads[b]`` in
    place, ``tile_grads`` an (m, D) tile already in the flat accumulator
    layout (zero over the alignment tail)."""
    return clip_accum_inplace(acc, tile_grads, norms, mask, clip_norm)
