"""Tile sizing for the streaming engine (the reference's
``launch/costmodel.stream_tile_size`` rule), budgeted against the device's
own free memory instead of a TPU's 16 GiB, and counting what the port's
engine really holds per example."""
from __future__ import annotations

import os

import torch

# live bytes beyond the per-example slabs: the flat f32 accumulator plus one
# params-sized f32 buffer (the reference's count, kept as margin: the port's
# accumulator already exists when free memory is read)
STREAM_FIXED_F32_BUFFERS = 2

# per-example gradient slabs (n_params * pe_dtype_bytes each) counted per
# example of the tile.  The backward of vmap(grad) holds two at its peak: the
# per-layer block gradients beside the stacked gradient that the blocks'
# ``unbind`` builds from them; saved activations add about half a slab on
# ViT-Base/16 at 224 px, and the (m, D) flat tile is built after that peak.
# The fourth slab is headroom for PyTorch's caching allocator, whose split
# blocks can leave tens of GB reserved but unusable at a large tile.
# ``chip_smoke.py`` measures the peak per example at two tiles and runs the
# engine at a batch where this rule binds
STREAM_PE_SLABS = 4


def stream_tile_size(batch_size: int, n_params: int, budget_bytes: float,
                     pe_dtype_bytes: int = 4) -> int:
    """Largest streaming tile m <= batch whose live state fits the budget:
    ``m * STREAM_PE_SLABS * n_params * pe_dtype_bytes`` plus
    :data:`STREAM_FIXED_F32_BUFFERS` params-sized f32 buffers."""
    fixed = STREAM_FIXED_F32_BUFFERS * 4.0 * n_params
    free = budget_bytes - fixed
    if free <= 0:
        return 1
    m = int(free // max(STREAM_PE_SLABS * n_params * pe_dtype_bytes, 1))
    return max(1, min(int(batch_size), m))


def free_memory_bytes(device) -> int:
    """Memory a new tensor on ``device`` can take: on a card the driver's
    free memory plus what PyTorch's caching allocator holds unused (after
    one tile those cached blocks are most of the room); on the CPU the
    host's available physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return int(torch.cuda.mem_get_info(device)[0]) + int(cached)
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
