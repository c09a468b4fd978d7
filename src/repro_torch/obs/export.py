"""Exporters: JSONL event log, snapshot helpers, ``torch.profiler`` traces,
as the reference package's ``obs/export.py``.

JSONL schema (version :data:`~repro_torch.obs.metrics.SCHEMA_VERSION`)
----------------------------------------------------------------------

The first line of every log is a header record::

    {"kind": "schema", "version": 1, "source": "repro_torch.obs"}

Every subsequent line is one record with a ``kind``:

* ``span``   — one timed phase: ``name``, ``parent`` (enclosing span or
  null), ``tick`` (step counter), ``t0`` (registry clock at entry),
  ``dur_s``, ``synced`` (True when the duration covered a wait on the
  phase's device output — sampled mode).
* ``gauge``  — ``name``, ``tick``, ``value``.
* ``event``  — structured one-offs: ``name``, ``tick`` plus free-form
  fields.
* ``stats``  — the aggregate flush :meth:`MetricsRegistry.dump_stats`
  writes: ``counters``, ``gauges`` and per-span count/total/mean/p50/p95.

:func:`read_jsonl` is the consuming side: it validates the header version
and returns the records.

Profiler traces
---------------

:func:`start_profile` / :func:`stop_profile` run a ``torch.profiler``
capture (host and, on a card, device activity) and write a Chrome trace
into the directory; while it is live, every registry built with
``ObsConfig(profile_dir=...)`` wraps its spans in
``torch.profiler.record_function`` so the phase names land in the timeline
next to the kernels they launched.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import List, Optional

from .metrics import SCHEMA_VERSION


class JsonlExporter:
    """Append-only JSONL event log with a schema-version header."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "w")
        self.emit({"kind": "schema", "version": SCHEMA_VERSION,
                   "source": "repro_torch.obs"})

    def emit(self, record: dict) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(record, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_jsonl(path: str, kind: Optional[str] = None) -> List[dict]:
    """Read an event log back, validating the schema header.  ``kind``
    filters to one record kind (the header is always dropped)."""
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if not records or records[0].get("kind") != "schema":
        raise ValueError(f"{path}: not a repro_torch.obs event log "
                         f"(missing schema header)")
    version = records[0].get("version")
    if version != SCHEMA_VERSION:
        raise ValueError(f"{path}: schema version {version} != supported "
                         f"{SCHEMA_VERSION}")
    body = records[1:]
    if kind is not None:
        body = [r for r in body if r.get("kind") == kind]
    return body


_PROFILE: dict = {}


def start_profile(profile_dir: str) -> bool:
    """Start a ``torch.profiler`` capture whose Chrome trace
    :func:`stop_profile` writes into ``profile_dir``.  Returns False (with a
    warning) when the profiler cannot start rather than failing the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:                                  # pragma: no cover
        warnings.warn(f"torch.profiler trace unavailable: {e}",
                      RuntimeWarning, stacklevel=2)
        return False
    _PROFILE.update(prof=prof, dir=profile_dir)
    return True


def stop_profile() -> Optional[str]:
    """Stop the capture; returns the trace file's path (None when no
    capture was running)."""
    prof = _PROFILE.pop("prof", None)
    if prof is None:
        return None
    prof.__exit__(None, None, None)
    out = os.path.join(_PROFILE.pop("dir"), "trace.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    prof.export_chrome_trace(out)
    return out
