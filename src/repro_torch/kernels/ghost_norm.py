"""Per-example ghost gradient norms of a dense layer: the Hopper kernel
(``csrc/ghost_norm.cu``) and its plain PyTorch version.

Replaces the reference package's TPU kernel ``ghost_norm_dense``
(``kernels/ghost_norm.py``)::

    n[b] = || X_b^T dY_b ||_F^2        x (B, T, din), dy (B, T, dout)

the direct path of the Mixed-Ghost rule, without writing the (din, dout)
per-example gradient to memory.  The reference pads T, din and dout to its
tiles and takes f32 inputs from the caller; the kernel masks the ragged edge
instead (zero rows add exact zeros) and takes f32 or bf16 inputs, upcast
per element in shared memory, so the bf16 records of the tape need no f32
copy.  It sums in another order than the plain version (tiles of 64 x 64,
T in slabs of 32, a two-stage fixed-order reduction), so the two agree to
f32 rounding, not bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

TILE_I = 64
TILE_O = 64
MAX_BATCH = 65535            # the kernel puts b on the grid's y axis


def n_tiles(din: int, dout: int) -> int:
    """Output tiles per example: the width of the partial-sum buffer."""
    return -(-din // TILE_I) * -(-dout // TILE_O)


def ghost_norm_dense_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the reference's ``ghost_norm_dense_ref``):
    the (B, din, dout) product in f32, then its sum of squares per b."""
    m = torch.einsum("bti,bto->bio", x.float(), dy.float())
    return (m * m).sum(dim=(1, 2))


def ghost_norm_dense(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x (B, T, din), dy (B, T, dout), both f32 or both bf16 and contiguous
    -> (B,) f32 per-example ``||X_b^T dY_b||_F^2``.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (or raises)."""
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"x must be (B, T, din) and dy (B, T, dout) with the "
                         f"same B and T, got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    if dy.device != x.device:
        raise ValueError(f"dy is on {dy.device}, x on {x.device}")
    if x.dtype != dy.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x and dy must both be float32 or both bfloat16, got "
                        f"{x.dtype} and {dy.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous")
    dev = x.device
    if dev.type == "cpu":
        return ghost_norm_dense_plain(x, dy)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, T, din = x.shape
    dout = dy.shape[2]
    if B > MAX_BATCH:
        raise ValueError(f"batch of {B} exceeds the kernel's {MAX_BATCH}")
    if B == 0 or din == 0 or dout == 0:
        return torch.zeros(B, dtype=torch.float32, device=dev)
    _build.require_hopper(dev)
    lib = _library()
    out = torch.empty(B, dtype=torch.float32, device=dev)
    partials = torch.empty(B, n_tiles(din, dout), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ghost_norm_dense_launch(
            x.data_ptr(), dy.data_ptr(), int(x.dtype == torch.bfloat16),
            partials.data_ptr(), out.data_ptr(), B, T, din, dout, stream)
    _build.check(lib, rc, "ghost_norm_dense")
    ghost_norm_dense.launches += 1
    return out


ghost_norm_dense.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("ghost_norm")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ghost_norm_dense_launch.argtypes = [P, P, I, P, P, I, I, I, I, P]
        lib.ghost_norm_dense_launch.restype = I
        lib._typed = True
    return lib
