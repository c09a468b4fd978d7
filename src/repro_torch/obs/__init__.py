"""Telemetry of the port: phase spans, DP-safe metrics, trace export — the
reference package's ``obs`` package on PyTorch.

* :mod:`.metrics` — a process-local :class:`MetricsRegistry` of counters,
  gauges and histograms plus ``span(name)`` phase timers: ``off`` (the
  default) is a strict no-op with ZERO added sync points, ``events`` times
  on the host clock with no sync, ``sampled`` waits on each span's watched
  tensor on sampled ticks.  Injectable clock and sync.
* :mod:`.export` — the schema-versioned JSONL event log and
  ``torch.profiler`` capture with spans as ``record_function`` ranges.

The taps live in :meth:`repro_torch.core.session.PrivacySession.fit`
(accumulate / update / account / eval spans, the checkpoint wait, the ε
and clip-fraction gauges read only from batch-aggregated values) and in
:class:`repro_torch.checkpoint.AsyncCheckpointer` (saves, retries,
failures, the copy and commit times).
"""
from __future__ import annotations

from .export import (JsonlExporter, read_jsonl, start_profile,  # noqa: F401
                     stop_profile)
from .metrics import (MODES, NULL_REGISTRY, SCHEMA_VERSION,  # noqa: F401
                      Histogram, MetricsRegistry, ObsConfig, add_cli_args,
                      as_registry, config_from_args, default_sync)

__all__ = [
    "MODES", "SCHEMA_VERSION", "Histogram", "MetricsRegistry", "ObsConfig",
    "NULL_REGISTRY", "as_registry", "add_cli_args", "config_from_args",
    "default_sync",
    "JsonlExporter", "read_jsonl", "start_profile", "stop_profile",
]
