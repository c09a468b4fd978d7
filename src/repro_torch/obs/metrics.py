"""The metrics core: counters / gauges / histograms + phase spans, as the
reference package's ``obs/metrics.py``.

One process-local :class:`MetricsRegistry` per session holds every metric;
instrumentation points ("taps") are cheap method calls that no-op entirely
in the default ``off`` mode, so the hot paths carry zero added work and
**zero added device sync points**.

Span timing under asynchronous CUDA launches
--------------------------------------------

Kernels are enqueued on a CUDA stream and the host runs ahead: wrapping a
launch in a host timer measures the enqueue, not the execution.  A
:meth:`MetricsRegistry.span` is therefore mode-aware:

* ``off``      — a shared no-op context manager; nothing is timed, nothing
                 is synced.
* ``events``   — host wall-clock timing on every tick, **no** sync points:
                 spans that launch device work measure the enqueue plus
                 whatever the runtime forced; host-only spans are exact.
* ``sampled``  — phase-accurate: on sampled ticks (every
                 ``sample_every``-th call to :meth:`tick`) a span that
                 declared a device output via :meth:`_Span.watch` waits for
                 it at the span boundary (the tensor's stream), so the
                 measured interval covers the device work the phase
                 launched.  Non-sampled ticks record nothing and sync
                 nothing.

The clock is injectable (``clock=``), and so is the sync (``sync=``); the
default (:func:`default_sync`) waits on the current stream of each CUDA
tensor it is given, or calls ``torch.cuda.synchronize`` for a value that
holds no tensor, and does nothing for CPU tensors.

Histograms keep a bounded ring of recent values (plus exact count/total),
with nearest-rank percentiles.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

#: JSONL event-log schema version (see :mod:`repro_torch.obs.export`).
#: Bump on any field rename/removal; consumers check it on read.
SCHEMA_VERSION = 1

MODES = ("off", "events", "sampled")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """CLI-facing observability knobs (``--metrics``, ``--metrics-every``,
    ``--metrics-jsonl``, ``--profile-dir``)."""
    mode: str = "off"                 # off | events | sampled
    sample_every: int = 1             # sampled mode: sync 1-in-N ticks
    jsonl: Optional[str] = None       # JSONL event-log path
    snapshot_every: int = 0           # human snapshot cadence (steps/iters)
    profile_dir: Optional[str] = None  # torch.profiler trace output dir

    def build(self) -> "MetricsRegistry":
        from .export import JsonlExporter
        mode = self.mode
        if self.profile_dir and mode == "off":
            # --profile-dir without --metrics still needs live spans to
            # wrap phases in record_function; events mode adds no syncs
            mode = "events"
        exporter = JsonlExporter(self.jsonl) if self.jsonl else None
        return MetricsRegistry(mode, sample_every=self.sample_every,
                               exporter=exporter,
                               snapshot_every=self.snapshot_every,
                               annotate=bool(self.profile_dir))


def add_cli_args(ap) -> None:
    """Install the shared observability flags on an argparse parser (the
    training CLI exposes them, as the reference's train and serve CLIs
    do)."""
    ap.add_argument("--metrics", default="off", choices=list(MODES),
                    help="telemetry mode: off (default, zero overhead), "
                         "events (no added syncs), sampled (phase-accurate "
                         "span timing via per-span sync points)")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="print a human-readable metrics snapshot to stderr "
                         "every N steps/iterations (0 = only at exit)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write the schema-versioned JSONL event log here")
    ap.add_argument("--sample-every", type=int, default=1,
                    help="sampled mode: sync/time 1-in-N ticks")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace into this "
                         "directory (spans become record_function ranges)")


def config_from_args(args) -> "ObsConfig":
    """The :class:`ObsConfig` described by :func:`add_cli_args` flags."""
    return ObsConfig(mode=args.metrics, sample_every=args.sample_every,
                     jsonl=args.metrics_jsonl,
                     snapshot_every=args.metrics_every,
                     profile_dir=args.profile_dir)


class Histogram:
    """Bounded-memory histogram: exact count/total/min/max plus a ring of
    the most recent ``cap`` observations for percentiles."""

    __slots__ = ("count", "total", "vmin", "vmax", "_ring")

    def __init__(self, cap: int = 4096):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._ring: collections.deque = collections.deque(maxlen=cap)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self._ring.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (ceil(q*n)-1) over the retained ring."""
        if not self._ring:
            return 0.0
        vals = sorted(self._ring)
        import math
        return vals[min(max(math.ceil(q * len(vals)) - 1, 0), len(vals) - 1)]


class _NullSpan:
    """Shared no-op span: off mode / non-sampled ticks."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def watch(self, x):
        return x


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("reg", "name", "parent", "t0", "_watch", "_sync", "_ann")

    def __init__(self, reg: "MetricsRegistry", name: str, sync: bool):
        self.reg = reg
        self.name = name
        self.parent: Optional[str] = None
        self._watch = None
        self._sync = sync
        self._ann = None

    def watch(self, x):
        """Declare the device value this span's work produces; in sampled
        mode the span blocks on it at exit so the duration is
        phase-accurate.  Returns ``x`` unchanged."""
        self._watch = x
        return x

    def __enter__(self):
        reg = self.reg
        self.parent = reg._stack[-1] if reg._stack else None
        reg._stack.append(self.name)
        if reg.annotate:
            import torch
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self.t0 = reg.clock()
        return self

    def __exit__(self, *exc):
        reg = self.reg
        if self._sync and self._watch is not None:
            reg.sync(self._watch)
        dur = reg.clock() - self.t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        reg._stack.pop()
        reg.observe(self.name, dur)
        if reg.exporter is not None:
            reg.exporter.emit({"kind": "span", "name": self.name,
                               "parent": self.parent, "tick": reg._tick,
                               "t0": round(self.t0, 6),
                               "dur_s": round(dur, 6),
                               "synced": bool(self._sync and
                                              self._watch is not None)})
        return False


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def default_sync(x) -> None:
    """Wait until the device work that produced ``x`` is done: the current
    stream of each CUDA tensor in ``x`` (a tensor, or a dict/list of them);
    ``torch.cuda.synchronize()`` when ``x`` holds no tensor and a card is
    in use; nothing for CPU tensors."""
    import torch
    tensors = list(_tensors(x))
    devices = {t.device for t in tensors if t.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    if not tensors and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class MetricsRegistry:
    """Process-local metric store + span factory (see module docstring)."""

    def __init__(self, mode: str = "off", *, sample_every: int = 1,
                 clock: Optional[Callable[[], float]] = None,
                 sync: Optional[Callable] = None, exporter=None,
                 snapshot_every: int = 0, annotate: bool = False):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.mode = mode
        self.sample_every = int(sample_every)
        self.clock = clock if clock is not None else time.perf_counter
        self.sync = sync if sync is not None else default_sync
        self.exporter = exporter
        self.snapshot_every = int(snapshot_every)
        self.annotate = bool(annotate)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self._stack: list = []
        self._tick = 0
        # until the first tick, sampled mode behaves as sampled (tick 0)
        self._sampled = mode == "sampled"

    # -- lifecycle ----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @property
    def sampled_now(self) -> bool:
        """True on ticks where device values may be read (sampled mode on a
        sampled tick).  Gates every host read of a device scalar."""
        return self.mode == "sampled" and self._sampled

    def tick(self) -> int:
        """Advance the iteration counter (one optimizer step / one scheduler
        iteration); decides whether this tick is sampled."""
        if self.mode == "off":
            return 0
        self._tick += 1
        self._sampled = (self._tick % self.sample_every) == 0
        return self._tick

    # -- taps ---------------------------------------------------------------

    def inc(self, name: str, n: float = 1) -> None:
        if self.mode == "off":
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        if self.mode == "off":
            return
        self.gauges[name] = float(value)
        if self.exporter is not None:
            self.exporter.emit({"kind": "gauge", "name": name,
                                "tick": self._tick,
                                "value": float(value)})

    def observe(self, name: str, value: float) -> None:
        if self.mode == "off":
            return
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.observe(value)

    def event(self, name: str, **data) -> None:
        """A structured one-off event (e.g. one request's lifecycle)."""
        if self.mode == "off" or self.exporter is None:
            return
        self.exporter.emit({"kind": "event", "name": name,
                            "tick": self._tick, **data})

    def span(self, name: str):
        """A phase-timer context manager (see module docstring).  Call
        ``.watch(device_value)`` inside the block to make the sampled-mode
        duration cover the dispatched device work."""
        if self.mode == "off":
            return NULL_SPAN
        if self.mode == "sampled" and not self._sampled:
            return NULL_SPAN
        return _Span(self, name, sync=self.mode == "sampled")

    # -- reporting ----------------------------------------------------------

    def totals(self, prefix: str = "") -> Dict[str, Tuple[int, float]]:
        """{name: (count, total_seconds)} for every histogram under
        ``prefix`` — the per-phase aggregation ``engine.run`` reports."""
        return {k: (h.count, h.total) for k, h in self.hists.items()
                if k.startswith(prefix)}

    def snapshot(self) -> str:
        """Human-readable state: counters, gauges, span p50/p95/mean."""
        lines = [f"# metrics snapshot (mode={self.mode}, tick={self._tick})"]
        for k in sorted(self.counters):
            lines.append(f"#   counter {k} = {self.counters[k]:g}")
        for k in sorted(self.gauges):
            lines.append(f"#   gauge   {k} = {self.gauges[k]:.6g}")
        for k in sorted(self.hists):
            h = self.hists[k]
            lines.append(
                f"#   span    {k}: n={h.count} mean={h.mean * 1e3:.3f}ms "
                f"p50={h.percentile(0.5) * 1e3:.3f}ms "
                f"p95={h.percentile(0.95) * 1e3:.3f}ms")
        return "\n".join(lines)

    def dump_stats(self) -> None:
        """Emit one aggregate ``stats`` record to the event log (counters +
        gauges + span percentiles) — the final-flush record."""
        if self.exporter is None or self.mode == "off":
            return
        self.exporter.emit({
            "kind": "stats", "tick": self._tick,
            "counters": dict(self.counters), "gauges": dict(self.gauges),
            "spans": {k: {"count": h.count,
                          "total_s": round(h.total, 6),
                          "mean_s": round(h.mean, 6),
                          "p50_s": round(h.percentile(0.5), 6),
                          "p95_s": round(h.percentile(0.95), 6)}
                      for k, h in self.hists.items()}})

    def close(self) -> None:
        self.dump_stats()
        if self.exporter is not None:
            self.exporter.close()


#: The shared off-mode registry every uninstrumented session/engine uses.
NULL_REGISTRY = MetricsRegistry("off")


def as_registry(obs) -> MetricsRegistry:
    """Coerce the ``obs=`` argument sessions/engines accept: None (off),
    an :class:`ObsConfig`, or an already-built :class:`MetricsRegistry`."""
    if obs is None:
        return NULL_REGISTRY
    if isinstance(obs, ObsConfig):
        return obs.build()
    if isinstance(obs, MetricsRegistry):
        return obs
    raise TypeError(f"obs must be None, ObsConfig or MetricsRegistry, "
                    f"got {type(obs).__name__}")
