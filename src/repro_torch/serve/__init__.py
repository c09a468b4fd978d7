"""Request-level serving in the port: continuous batching over a slot-based
decode-cache pool, the reference's ``serve`` package on the decode
primitives (``init_cache``/``decode_step``/``prefill_step``) of the dense
LMs (a KV cache), Mamba2 (an SSM state and conv tail a layer) and the
Zamba2 hybrid (both):

  * :mod:`~repro_torch.serve.request`    — Request / SamplingParams /
                                           RequestState
  * :mod:`~repro_torch.serve.cache_pool` — one (max_slots, max_len) cache,
                                           per-slot insert/evict/reset
                                           (accumulating leaves restored
                                           to the template),
                                           [B] position vector,
                                           PrefixIndex prompt-prefix
                                           sharing with in-place row
                                           copies on the device
  * :mod:`~repro_torch.serve.sampling`   — per-request greedy/temperature/
                                           top-k token selection
  * :mod:`~repro_torch.serve.scheduler`  — iteration-level continuous
                                           batching, mid-flight admission
                                           and retirement, chunked prefill
                                           under a per-iteration token
                                           budget, recovery, cancel
  * :mod:`~repro_torch.serve.engine`     — ServeEngine.from_session: the
                                           pool + scheduler through the
                                           session's executor

The session's ``serve_engine``/``generate`` and ``repro_torch.launch.serve``
(the CLI) are the entry points over it.  Still to come (ROADMAP queue 1):
the MoE, MLA, Whisper and VLM caches (item 2); serving on a mesh (item 5).
"""
from .cache_pool import CachePool, PrefixIndex
from .engine import (ServeEngine, latency_percentiles, percentiles,
                     ttft_percentiles)
from .request import Request, RequestState, SamplingParams
from .sampling import sample_tokens
from .scheduler import Scheduler

__all__ = ["CachePool", "PrefixIndex", "ServeEngine", "Request",
           "RequestState", "SamplingParams", "Scheduler",
           "latency_percentiles", "percentiles", "sample_tokens",
           "ttft_percentiles"]
