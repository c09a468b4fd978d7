"""BatchMemoryManager: logical -> fixed-size physical batches with masks.

This is the host half of Algorithm 2.  A Poisson-sampled logical batch of
variable size tl is padded up to k*p examples (k = ceil(tl / p)); the first tl
mask entries are 1, the padding entries 0.  Every physical batch the device
sees therefore has the SAME shape (p, ...) — jit compiles once — while the
masked clipped-gradient sum is exactly the sum over the true logical batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PhysicalBatch:
    data: dict            # pytree of arrays, leading dim = physical size p
    mask: "np.ndarray"    # (p,) float32 0/1; a placed tensor when the
                          # manager was built with an executor place hook
    is_last: bool         # True on the final physical batch of a logical batch
    logical_size: int     # tl of the surrounding logical batch


class BatchMemoryManager:
    """Iterate physical batches for each logical index draw.

    fetch(indices) -> pytree with leading axis len(indices); padding examples
    re-fetch index 0 but are masked out, so their gradients never contribute.

    ``place`` is the executor's placement hook ``(data, mask) -> (data,
    mask)``: when given, every physical batch is moved to its device (or
    mesh sharding) as it is produced, so host->device transfer overlaps the
    step instead of sitting on its critical path.
    """

    def __init__(self, fetch: Callable[[np.ndarray], dict], physical: int,
                 place: Optional[Callable] = None):
        self.fetch = fetch
        self.p = physical
        self.place = place

    def batches(self, logical_indices: np.ndarray) -> Iterator[PhysicalBatch]:
        tl = len(logical_indices)
        k = max(1, -(-tl // self.p))          # ceil; at least one batch
        m = k * self.p
        padded = np.zeros(m, dtype=np.int64)
        padded[:tl] = logical_indices
        mask = np.zeros(m, dtype=np.float32)
        mask[:tl] = 1.0
        for s in range(k):
            sl = slice(s * self.p, (s + 1) * self.p)
            data, mk = self.fetch(padded[sl]), mask[sl]
            if self.place is not None:
                data, mk = self.place(data, mk)
            yield PhysicalBatch(
                data=data,
                mask=mk,
                is_last=(s == k - 1),
                logical_size=tl,
            )
