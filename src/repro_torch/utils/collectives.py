"""The sum of the ranks' flat accumulators, in a fixed order.

:func:`fold_sum_` leaves on every rank of a group the strict left fold
``((a_0 + a_1) + a_2) + ...`` of the ranks' flat tensors in rank order, so
its bits are a function of the partial sums alone, whatever the backend
(NCCL's and gloo's all-reduce orders are their own, and for more than two
ranks they round differently).  It moves what a ring all-reduce moves:

1. ``all_to_all``: rank j receives slice j of every rank's tensor;
2. rank j folds the N slices it holds, in rank order, one rounded add each;
3. ``all_gather``: every rank receives every folded slice.

With one rank it is the identity.  A tensor whose length does not divide
by N is padded with zeros for the exchange (a zero added is exact).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def fold_sum_(flat: torch.Tensor, group=None) -> torch.Tensor:
    """Replace ``flat`` on every rank of ``group`` (None: the default
    group) by the rank-order left fold of the ranks' ``flat``; returns
    ``flat``.  Every rank must call it with a tensor of the same length,
    dtype and device type."""
    n = dist.get_world_size(group)
    if n == 1:
        return flat
    if not flat.is_contiguous():
        raise ValueError("fold_sum_ needs a contiguous tensor")
    vec = flat.view(-1)
    d = vec.numel()
    c = -(-d // n)
    if c * n == d:
        send = vec
    else:
        send = torch.zeros(c * n, dtype=vec.dtype, device=vec.device)
        send[:d] = vec
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    parts = recv.view(n, c)
    acc = parts[0]
    for j in range(1, n):
        acc.add_(parts[j])
    dist.all_gather_into_tensor(send, acc, group=group)
    if send is not vec:
        vec.copy_(send[:d])
    return flat

