"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is no card (the port never falls back to the CPU by itself).

    On a CUDA device this also turns TF32 off for matmuls and cuDNN: the
    reference computes its f32 products in full f32, and TF32 keeps about
    three decimal digits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:                # compare equal to tensors' devices
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
