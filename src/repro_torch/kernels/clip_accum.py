"""In-place clipped masked accumulate: the Hopper kernel
(``csrc/clip_accum.cu``), its plain PyTorch version, and the streaming
engine's ``flat_clip_accum``.

Replaces the reference package's TPU kernel ``clip_accum_inplace``
(``kernels/clip_accum.py``)::

    acc[d] += sum_b mask_b * min(1, C / max(norm_b, 1e-12)) * g[b, d]

as a strict left fold over ``b`` from the carry (the reference's
``_fold_rows``), with no fused multiply-add: the result is then the same
for every tile size and bitwise equal to the ``masked_pe`` oracle's fold.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# the kernel keeps the m coefficients in shared memory (48 KB without opt-in)
MAX_TILE = 12288


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


def clip_accum_inplace(acc, grads, norms, mask, clip_norm):
    """acc (D,) f32 += sum_b mask_b min(1, C/norm_b) grads[b], in place.

    ``grads`` is an (m, D) tile, f32 or bf16 (upcast in the kernel),
    already in the accumulator's layout; ``norms`` and ``mask`` are (m,)
    f32.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    dev = acc.device
    if grads.dim() != 2:
        raise ValueError(f"grads must be (m, D), got {tuple(grads.shape)}")
    m, d = grads.shape
    for name, t, shape, dtypes in (
            ("acc", acc, (d,), (torch.float32,)),
            ("grads", grads, (m, d), (torch.float32, torch.bfloat16)),
            ("norms", norms, (m,), (torch.float32,)),
            ("mask", mask, (m,), (torch.float32,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, acc on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)} (pad the tile to the "
                             f"accumulator layout before the call)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cpu":
        return clip_accum_inplace_plain(acc, grads, norms, mask, clip_norm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if m > MAX_TILE:
        raise ValueError(f"tile of {m} rows exceeds the kernel's {MAX_TILE}")
    _build.require_hopper(dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.clip_accum_inplace_launch(
            acc.data_ptr(), grads.data_ptr(),
            int(grads.dtype == torch.bfloat16), norms.data_ptr(),
            mask.data_ptr(), float(clip_norm), m, d, stream)
    _build.check(lib, rc, "clip_accum_inplace")
    clip_accum_inplace.launches += 1
    return acc


clip_accum_inplace.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("clip_accum")
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        lib.clip_accum_inplace_launch.argtypes = [
            P, P, ctypes.c_int, P, P, ctypes.c_float, ctypes.c_int,
            ctypes.c_int64, P]
        lib.clip_accum_inplace_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def flat_clip_accum(acc, tile_grads, norms, mask, clip_norm):
    """Streaming accumulate: ``acc (D,) += sum_b coef_b tile_grads[b]`` in
    place, ``tile_grads`` an (m, D) tile already in the flat accumulator
    layout (zero over the alignment tail)."""
    return clip_accum_inplace(acc, tile_grads, norms, mask, clip_norm)
