"""Per-request token sampling, as one batched call: the reference's
``serve/sampling.py``.

Each row carries its own (temperature, top_k, seed): greedy rows
(temperature == 0) take the argmax, sampling rows draw from the
temperature-scaled, optionally top-k-truncated distribution by the
Gumbel-max trick.  A row's random stream is ``fold_in(PRNGKey(seed),
position)``, a function of the request's own seed and position only, so a
sampled token does not depend on the slot, the batch or the admission time.

The key path is JAX's, bit for bit, on the port's own Threefry-2x32
(:func:`~repro_torch.kernels.noisy_update.threefry2x32`, here with one key
per row), as ``jax.random`` builds it with ``jax_threefry_partitionable``
on (the default):

* ``PRNGKey(seed)`` for an int32 seed is the key ``(0, seed mod 2^32)``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d mod 2^32))``;
* ``split(key, n)``'s key i is ``threefry2x32(key, (0, i))``;
* the 32-bit random bits of element j of a flat draw are ``x0 ^ x1`` of
  ``threefry2x32(key, (0, j))`` (the counter is j's 64-bit iota split
  into its high and low words);
* the uniform on [tiny, 1) sets the bits' top 23 as the mantissa of a
  float in [1, 2), subtracts 1, then scales by (1 - tiny), which rounds to
  1, adds tiny and floors at tiny (``jax.random._uniform``);
* the Gumbel draw is ``-log(-log(u))`` (``_gumbel``'s "low" mode, JAX's
  default unless ``jax_high_dynamic_range_gumbel`` is set);
* ``randint`` is ``jax.random._randint`` for int32: two 32-bit draws from
  ``split(key)``'s two keys, reduced modulo the uint32 span with JAX's
  multiplier ``(2^16 mod span)^2 mod span`` (the square wraps at 2^32).

The integers and the uniform are exact; ``log`` differs by ULPs between
XLA, PyTorch's CPU and CUDA, so the Gumbel values agree within a stated
ULP bound (``tests/test_torch_sampling.py``).  Everything runs on the
logits' device.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..kernels.noisy_update import threefry2x32

_M32 = 0xFFFFFFFF
# np.finfo(np.float32).tiny, the uniform's lower end
_TINY = 1.1754943508222875e-38
# the bit pattern of 1.0f: OR-ed under 23 random mantissa bits
_ONE_BITS = 0x3F800000

Key = Tuple[torch.Tensor, torch.Tensor]


def prng_key(seeds: torch.Tensor) -> Key:
    """``jax.random.PRNGKey(seed)`` per row of int32 ``seeds`` (B,): the key
    words (0, seed mod 2^32) as int64 tensors."""
    seeds = seeds.to(torch.int64)
    return torch.zeros_like(seeds), seeds & _M32


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in(key, data)`` per row: (B,) integer ``data``."""
    data = data.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` per row: ``num`` keys, key i being
    ``threefry2x32(key, (0, i))`` (the partitionable split)."""
    out = []
    for i in range(num):
        count = torch.full_like(key[0], i)
        out.append(threefry2x32(key[0], key[1], torch.zeros_like(count),
                                count))
    return out


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per row: (B, n) int64 holding
    uint32."""
    j = torch.arange(n, dtype=torch.int64, device=key[0].device)[None, :]
    b1, b2 = threefry2x32(key[0][:, None], key[1][:, None],
                          torch.zeros_like(j), j)
    return b1 ^ b2


def randint(key: Key, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for one
    key, its words of shape (1,) (``prng_key`` of one seed): int32 of
    ``shape`` on the key's device.  The bounds are int32 values."""
    for v in (minval, maxval):
        if not -2 ** 31 <= v < 2 ** 31:
            raise ValueError(f"randint's bounds must be int32 values, got {v}")
    n = math.prod(shape)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, n)[0], random_bits(k2, n)[0]
    # the span as uint32 (1 when maxval <= minval: minval is returned);
    # every product below stays under 2^32: the multiplier is 0 once the
    # span passes 2^16, and below it both factors are under 2^16
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (((2 ** 16 % span) ** 2) & _M32) % span
    offset = (((higher % span) * mult + lower % span) & _M32) % span
    out = (minval + offset) & _M32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(
        torch.int32).reshape(shape)


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, minval=tiny, maxval=1.)`` from the key's
    ``random_bits``: f32 of the bits' shape."""
    floats = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)
    # filled on the device: torch.tensor would copy from the host and sync
    tiny = torch.full((), _TINY, dtype=torch.float32, device=bits.device)
    span = torch.full((), 1.0, dtype=torch.float32, device=bits.device) - tiny
    return torch.maximum(tiny, (floats - 1.0) * span + tiny)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per row: (B, n) f32."""
    return -torch.log(-torch.log(uniform(random_bits(key, n))))


def sample_tokens(logits: torch.Tensor, positions, seeds, temperatures,
                  top_ks) -> torch.Tensor:
    """Select the next token per row.

    logits        (B, V) float
    positions     (B,)   int    position the logits were produced at
    seeds         (B,)   int32  per-request seeds
    temperatures  (B,)   float  0 -> greedy
    top_ks        (B,)   int    0 -> no truncation
    Returns (B,) int32 tokens, on the logits' device.
    """
    dev = logits.device
    positions, seeds, temperatures, top_ks = (
        torch.as_tensor(t, device=dev)
        for t in (positions, seeds, temperatures, top_ks))
    B, V = logits.shape
    lf = logits.float()
    greedy_tok = lf.argmax(dim=-1)              # the first maximum, as JAX's

    # temperature scaling (the guard keeps greedy rows finite)
    temp = temperatures.float().clamp_min(1e-6)[:, None]
    scaled = lf / temp

    # top-k with a per-row k: keep every logit >= the k-th largest (ties at
    # the k-th value all stay, unlike torch.topk's exact k)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_ks > 0, top_ks, V).long()
    kth = sorted_desc.gather(-1, (k - 1).clamp(0, V - 1)[:, None])
    scaled = torch.where(scaled >= kth, scaled, -torch.inf)

    # Gumbel-max with each row's key from (seed, position) only
    g = gumbel(fold_in(prng_key(seeds), positions), V)
    sampled_tok = (scaled + g).argmax(dim=-1)
    return torch.where(temperatures > 0, sampled_tok,
                       greedy_tok).to(torch.int32)
