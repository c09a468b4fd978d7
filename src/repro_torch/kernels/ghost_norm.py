"""Per-example ghost gradient norms of a dense layer: the Hopper kernel
(``csrc/ghost_norm.cu``) and its plain PyTorch version.

Replaces the reference package's TPU kernel ``ghost_norm_dense``
(``kernels/ghost_norm.py``)::

    n[b] = || X_b^T dY_b ||_F^2        x (B, T, din), dy (B, T, dout)

the direct path of the Mixed-Ghost rule, without writing the (din, dout)
per-example gradient to memory.  The reference pads T, din and dout to its
tiles and takes f32 inputs from the caller; the kernel masks the ragged edge
instead (zero rows add exact zeros) and takes the tape's bf16 records as
they are.

One launch per call.  bf16 inputs run the product on the tensor cores (bf16
operands, f32 accumulation: a bf16 product is exact in f32, so this is the
same function as the f32 product of the upcast inputs), one block per
128 x 128 output tile.  f32 inputs run it on the CUDA cores in f32, one block
per 64 x 64 tile (TF32 would round the inputs).  Each block writes its
tile's sum of squares into a partial buffer and takes an integer ticket for
its example; the last block of an example sums the partials in tile order.
The scratch (partials and tickets) is kept per device and stream, so calls
that overlap on two streams never share it, and grown as needed; the kernel
leaves the tickets at zero.  The kernel sums in another order
than the plain version, so the two agree to f32 rounding, not bitwise.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

TILE_I = 64                  # the f32 body's output tile
TILE_O = 64
MMA_TILE_I = 128             # the bf16 tensor-core body's output tile
MMA_TILE_O = 128
MAX_BATCH = 65535            # the kernel puts b on the grid's y axis


def n_tiles(din: int, dout: int, dtype=torch.float32) -> int:
    """Output tiles per example for inputs of ``dtype``: the width of a row
    of the partial-sum buffer."""
    ti, to = ((MMA_TILE_I, MMA_TILE_O) if dtype == torch.bfloat16
              else (TILE_I, TILE_O))
    return -(-din // ti) * -(-dout // to)


def scratch_sizes(batch: int, din: int, dout: int, dtype) -> Tuple[int, int]:
    """(f32 partials, uint32 tickets) one call needs."""
    return batch * n_tiles(din, dout, dtype), batch


def ghost_norm_dense_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the reference's ``ghost_norm_dense_ref``):
    the (B, din, dout) product in f32, then its sum of squares per b."""
    m = torch.einsum("bti,bto->bio", x.float(), dy.float())
    return (m * m).sum(dim=(1, 2))


# (device, stream handle) -> (f32 partials, int32 tickets, all zero
# between calls).  Calls on one stream run in order; calls on two streams
# may overlap, so each stream has its own
_SCRATCH: Dict[Tuple[torch.device, int],
               Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device, stream: int, n_partials: int, n_tickets: int):
    """The scratch of ``stream`` on ``device``, grown to at least the
    sizes asked for and allocated while that stream is current (the
    caching allocator then reuses its memory on that stream only).  A new
    ticket buffer is zeroed once; the kernel leaves it zeroed."""
    key = (device, stream)
    have = _SCRATCH.get(key)
    if have is None or have[0].numel() < n_partials \
            or have[1].numel() < n_tickets:
        n_partials = max(n_partials, have[0].numel() if have else 0)
        n_tickets = max(n_tickets, have[1].numel() if have else 0)
        have = (torch.empty(n_partials, dtype=torch.float32, device=device),
                torch.zeros(n_tickets, dtype=torch.int32, device=device))
        _SCRATCH[key] = have
    return have


def ghost_norm_dense(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x (B, T, din), dy (B, T, dout), both f32 or both bf16 and contiguous
    -> (B,) f32 per-example ``||X_b^T dY_b||_F^2``.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel once (or raises)."""
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        partials, tickets = _scratch(dev, stream,
                                     *scratch_sizes(B, din, dout, x.dtype))
        rc = lib.ghost_norm_dense_launch(
            x.data_ptr(), dy.data_ptr(), int(x.dtype == torch.bfloat16),
            partials.data_ptr(), tickets.data_ptr(), out.data_ptr(), B, T,
            din, dout, stream)
    _build.check(lib, rc, "ghost_norm_dense")
    ghost_norm_dense.launches += 1
    return out


ghost_norm_dense.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.library("ghost_norm")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ghost_norm_dense_launch.argtypes = [P, P, I, P, P, P, I, I, I, I,
                                                P]
        lib.ghost_norm_dense_launch.restype = I
        lib.ghost_norm_dense_tiles.argtypes = [I, I, I]
        lib.ghost_norm_dense_tiles.restype = I
        for bf16 in (0, 1):
            dt = torch.bfloat16 if bf16 else torch.float32
            if lib.ghost_norm_dense_tiles(200, 300, bf16) != n_tiles(
                    200, 300, dt):
                raise RuntimeError("csrc/ghost_norm.cu tiles differently "
                                   "from the wrapper")
        lib._typed = True
    return lib
