"""Serving in the port: so far the per-request sampler (the model's decode
primitives are ``DenseLM.init_cache``/``decode_step``/``prefill_step``)."""
from .sampling import sample_tokens

__all__ = ["sample_tokens"]
