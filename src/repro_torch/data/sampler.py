"""Samplers behind a registry — the "no shortcuts" menu, not a single path.

A numpy copy of the reference package's ``data/sampler.py``: same registry,
same four samplers, same v2 Philox domain tags, so ``at_step(k)`` gives the
reference's masks bit for bit.

The paper's core requirement is that each logical batch really is drawn by
the process the accountant charges.  For the default :class:`PoissonSampler`
that is an independent Bernoulli(q) coin per training example (NOT shuffling
+ slicing, which voids the Poisson-subsampled accounting; Lebeda et al.,
2024 / arxiv 2411.04205).  Related work turns the alternatives into a menu
with different privacy/throughput trade-offs, so the samplers live behind a
decorator registry symmetric to ``@repro_torch.core.clipping.register_engine``:

  * ``poisson``        — Bernoulli(q) per example; Poisson-subsampled RDP.
  * ``balls_and_bins`` — each example lands in one of ``steps_per_epoch``
                         bins per epoch (arxiv 2412.16802): fixed EXPECTED
                         batch size with Poisson-like amplification.
  * ``shuffle``        — the shortcut baseline (De et al., 2022-style
                         epoch shuffling).  Accounting falls back to the
                         UNAMPLIFIED Gaussian bound so the shortcut's true
                         cost is visible instead of silently mis-accounted.
  * ``full_batch``     — q = 1 degenerate case (bench floors); unamplified.

Every sampler declares its ``accounting`` trait at registration
(``"amplified"`` → Poisson-subsampled RDP, ``"unamplified"`` → plain
Gaussian RDP); :func:`repro_torch.privacy.rdp.compose_for` dispatches on it.

**Counter-based, exactly-once.**  Step ``k``'s draw is a pure function of
``(seed, domain, k)``: a fresh ``np.random.Generator`` over a
``np.random.Philox`` bit generator keyed by the triple, never a sequential
stream advanced draw by draw.  ``at_step(k)`` is therefore history-free, and
a training run resumed from a step-``k`` checkpoint continues the stream at
``k`` instead of replaying draws 0..k-1 — replayed draws would make the
executed sampling distribution diverge from the accounted one (the
sampler/accountant mismatch of the shuffling-vs-Poisson analyses,
arxiv 2411.04205; per-step addressability is the same property
balls-and-bins implementations insist on, arxiv 2412.16802).  The
registration decorator enforces this contract behaviourally (``at_step(k)``
must equal the k-th iterated draw, and ``start_step=k`` must yield exactly
the stream's tail); the reference package's lint rule L006 keeps
sequential host RNGs out of registered samplers wherever they live.

**Stream version 2 — domain-separated Philox keys.**  Version 1 keyed
Philox as bare ``(seed, step)``, so at equal seeds a Poisson step-``k``
draw and a Shuffle epoch-``k`` permutation consumed the IDENTICAL random
stream.  Version 2 folds a per-sampler/per-purpose domain tag into the
high bits of the 128-bit key's counter word, so no two purposes can ever
share a stream.  This deliberately breaks v1 sampler streams; checkpoints
record :data:`SAMPLER_STREAM_VERSION` and ``PrivacySession.restore`` warns
when resuming across the break (a resumed pre-v2 run is correct DP-wise —
the accountant history is what it charges — but is no longer bitwise
comparable to an uninterrupted pre-v2 run).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Type

import numpy as np

_MASK64 = (1 << 64) - 1
_DOMAIN_BITS = 8
_STEP_BITS = 64 - _DOMAIN_BITS
_MASK_STEP = (1 << _STEP_BITS) - 1

#: Philox key-domain tags: one per independent stream purpose.  0 is the
#: legacy v1 encoding (bare ``(seed, step)`` keys) kept addressable so the
#: version break is testable; registered samplers each get their own tag.
DOMAIN_LEGACY = 0
DOMAIN_POISSON = 1
DOMAIN_SHUFFLE = 2
DOMAIN_BALLS_AND_BINS = 3

#: Bumped whenever the mapping (seed, step) -> sampler stream changes.
#: v1: bare (seed, step) Philox keys (Poisson and Shuffle collided).
#: v2: per-sampler domain tag in the counter word's high bits.
SAMPLER_STREAM_VERSION = 2


def step_rng(seed: int, step: int, domain: int = DOMAIN_LEGACY
             ) -> np.random.Generator:
    """The counter-based per-step generator: Philox keyed by
    ``(seed, domain, step)``.

    The 128-bit Philox key is ``seed`` in the high word and
    ``(domain << 56) | step`` in the low (counter) word, so distinct
    (seed, domain, step) triples get distinct, independent streams, the
    k-th draw never depends on draws 0..k-1, and two PURPOSES (e.g. a
    Poisson step draw vs a Shuffle epoch permutation) can never collide at
    equal seeds.  ``domain=0`` reproduces the legacy v1 bare-(seed, step)
    key for steps below 2**56.
    """
    domain = int(domain)
    if not 0 <= domain < (1 << _DOMAIN_BITS):
        raise ValueError(f"domain must be in [0, {1 << _DOMAIN_BITS}), "
                         f"got {domain}")
    counter = (domain << _STEP_BITS) | (int(step) & _MASK_STEP)
    key = ((int(seed) & _MASK64) << 64) | counter
    return np.random.Generator(np.random.Philox(key=key))


# ---------------------------------------------------------------------------
# sampler registry (symmetric to core.clipping's engine registry)
# ---------------------------------------------------------------------------

class SamplerRegistry(dict):
    """Name -> sampler class mapping that fails listing what IS registered."""

    def __getitem__(self, name):
        try:
            return super().__getitem__(name)
        except KeyError:
            raise KeyError(
                f"Unknown sampler {name!r}. Registered samplers: "
                f"{available_samplers()}. Register custom samplers with "
                f"@repro_torch.data.sampler.register_sampler(name, "
                f"accounting=...).") from None


SAMPLERS: "SamplerRegistry" = SamplerRegistry()

_ACCOUNTING_KINDS = ("amplified", "unamplified")


def _enforce_counter_contract(name: str, cls: Type) -> None:
    """Behavioural registration gate: the counter-based ``at_step(k)`` /
    ``start_step`` contract is what makes resume exactly-once, so a sampler
    that violates it never enters the registry.  Probes a tiny instance:
    ``at_step(k)`` must equal the k-th iterated draw, and an iterator
    started at ``start_step=k`` must yield exactly the tail of the full
    stream (continue, never replay)."""
    probe = cls.from_rate(n=8, q=0.5, seed=3, steps=6)
    full = [np.asarray(ix).tolist() for ix in probe]
    by_step = [np.asarray(cls.from_rate(n=8, q=0.5, seed=3).at_step(k)).tolist()
               for k in range(6)]
    tail = [np.asarray(ix).tolist()
            for ix in cls.from_rate(n=8, q=0.5, seed=3, steps=4, start_step=2)]
    if by_step != full or tail != full[2:]:
        raise TypeError(
            f"sampler {name!r} ({cls.__name__}) violates the counter-based "
            f"contract: at_step(k) must equal the k-th iterated draw and "
            f"start_step=k must continue (not replay) the stream — resume "
            f"would not be exactly-once")


def register_sampler(name: str, *, accounting: str):
    """Decorator: register a sampler class under ``name``.

    ``accounting`` declares which RDP bound is VALID for the sampler
    ("amplified" = Poisson-subsampled Gaussian RDP, "unamplified" = plain
    Gaussian RDP — the true cost of shortcut samplers);
    :func:`repro_torch.privacy.rdp.compose_for` dispatches on it.

    Registration enforces the structural contract (dataclass fields ``n`` /
    ``seed`` / ``steps`` / ``start_step``, an ``at_step``/``__iter__`` pair,
    a ``from_rate`` constructor, ``q`` and ``expected_batch_size``
    properties) AND the behavioural counter-based contract (see
    :func:`_enforce_counter_contract`), so a registered sampler cannot
    silently break exactly-once resume or per-sampler accounting.
    """
    if accounting not in _ACCOUNTING_KINDS:
        raise ValueError(f"accounting must be one of {_ACCOUNTING_KINDS}, "
                         f"got {accounting!r}")

    def deco(cls: Type) -> Type:
        if not dataclasses.is_dataclass(cls):
            raise TypeError(f"sampler {name!r} must be a dataclass")
        fields = {f.name for f in dataclasses.fields(cls)}
        missing = {"n", "seed", "steps", "start_step"} - fields
        if missing:
            raise TypeError(f"sampler {name!r} is missing the registry "
                            f"contract fields {sorted(missing)}")
        for attr in ("at_step", "__iter__", "from_rate"):
            if not callable(getattr(cls, attr, None)):
                raise TypeError(f"sampler {name!r} must define {attr}()")
        for prop in ("q", "expected_batch_size"):
            if not (hasattr(cls, prop) or prop in fields):
                raise TypeError(f"sampler {name!r} must expose .{prop} — "
                                f"the accountant and sigma calibration "
                                f"read it")
        _enforce_counter_contract(name, cls)
        cls.kind = name
        cls.accounting = accounting
        SAMPLERS[name] = cls
        return cls
    return deco


def available_samplers() -> List[str]:
    return sorted(SAMPLERS)


def resolve_sampler(name: str) -> Type:
    """The registered sampler class for ``name`` (helpful KeyError)."""
    return SAMPLERS[name]


def sampler_accounting(name: str) -> str:
    """The accounting trait ("amplified" | "unamplified") ``name`` declared
    at registration — what :func:`repro_torch.privacy.rdp.compose_for` dispatches
    on."""
    return SAMPLERS[name].accounting


def make_sampler(name: str, *, n: int, q: float, seed: int = 0,
                 steps: Optional[int] = None, start_step: int = 0):
    """Build a registered sampler from the session-level (n, q) knobs.

    Each class maps the nominal rate ``q`` onto its own parameters in
    ``from_rate`` (poisson: q itself; shuffle: batch_size = round(q*n);
    balls_and_bins: steps_per_epoch = round(1/q); full_batch: ignores q).
    Read the instance's ``.q`` back for the EFFECTIVE per-example rate the
    accountant must charge.
    """
    return resolve_sampler(name).from_rate(n=n, q=q, seed=seed, steps=steps,
                                           start_step=start_step)


def _validate_common(name: str, n: int, q: float) -> None:
    if int(n) <= 0:
        raise ValueError(f"{name}: dataset size n must be positive, got {n}")
    if not 0.0 < float(q) <= 1.0:
        raise ValueError(f"{name}: sampling rate q must be in (0, 1], got "
                         f"{q} (q <= 0 draws empty batches forever; q > 1 "
                         f"is not a probability)")


def _check_step(name: str, k: int) -> int:
    k = int(k)
    if k < 0:
        raise ValueError(f"{name}.at_step(k): step index must be >= 0, "
                         f"got {k}")
    return k


# ---------------------------------------------------------------------------
# the registered samplers
# ---------------------------------------------------------------------------

@register_sampler("poisson", accounting="amplified")
@dataclasses.dataclass
class PoissonSampler:
    """Independent Bernoulli(q) per example; len varies per draw (that's
    the point).  ``at_step(k)`` returns the k-th (absolute) logical batch
    directly; iteration yields ``steps`` draws starting at ``start_step`` —
    a resumed ``fit()`` passes the restored optimizer step so the stream
    continues where the uninterrupted run would be.
    """
    n: int                       # dataset size
    q: float                     # per-example sampling probability (= L / N)
    seed: int = 0
    steps: Optional[int] = None  # None = infinite
    start_step: int = 0          # absolute step the iteration stream starts at

    def __post_init__(self):
        _validate_common("PoissonSampler", self.n, self.q)

    @classmethod
    def from_rate(cls, *, n: int, q: float, seed: int = 0,
                  steps: Optional[int] = None, start_step: int = 0
                  ) -> "PoissonSampler":
        return cls(n=n, q=q, seed=seed, steps=steps, start_step=start_step)

    def at_step(self, k: int) -> np.ndarray:
        """The step-``k`` Bernoulli(q) draw, history-free."""
        k = _check_step("PoissonSampler", k)
        mask = step_rng(self.seed, k, DOMAIN_POISSON).random(self.n) < self.q
        return np.nonzero(mask)[0]

    def __iter__(self) -> Iterator[np.ndarray]:
        t = self.start_step
        while self.steps is None or t < self.start_step + self.steps:
            yield self.at_step(t)
            t += 1

    @property
    def expected_batch_size(self) -> float:
        return self.n * self.q


@register_sampler("shuffle", accounting="unamplified")
@dataclasses.dataclass
class ShuffleSampler:
    """The SHORTCUT sampler (De et al., 2022-style shuffling) — implemented
    only as a baseline to *demonstrate* the discrepancy; its registration
    declares ``accounting="unamplified"`` so the accountant charges the
    plain Gaussian RDP bound (the shuffled-composition analyses of
    arxiv 2411.04205 show shuffling does NOT enjoy the Poisson-subsampled
    bound), making the shortcut's true privacy cost visible.

    Counter-based like :class:`PoissonSampler`: epoch ``e``'s permutation is
    a pure function of ``(seed, e)`` under :data:`DOMAIN_SHUFFLE`, and
    ``at_step(k)`` slices the concatenation of consecutive epoch
    permutations — so even the shortcut baseline resumes exactly-once.
    When ``batch_size`` does not divide ``n``, the epoch tail is NOT
    dropped: slicing runs over the epoch boundary into the next epoch's
    permutation, so every example still appears exactly once per
    ``n``-example window.
    """
    n: int
    batch_size: int
    seed: int = 0
    steps: Optional[int] = None
    start_step: int = 0

    def __post_init__(self):
        if int(self.n) <= 0:
            raise ValueError(f"ShuffleSampler: dataset size n must be "
                             f"positive, got {self.n}")
        if not 0 < int(self.batch_size) <= int(self.n):
            raise ValueError(f"ShuffleSampler: batch_size must be in "
                             f"[1, n={self.n}], got {self.batch_size}")

    @classmethod
    def from_rate(cls, *, n: int, q: float, seed: int = 0,
                  steps: Optional[int] = None, start_step: int = 0
                  ) -> "ShuffleSampler":
        _validate_common("ShuffleSampler", n, q)
        return cls(n=n, batch_size=max(1, round(q * n)), seed=seed,
                   steps=steps, start_step=start_step)

    @property
    def q(self) -> float:
        """Effective per-step participation rate (batch_size / n)."""
        return self.batch_size / self.n

    @property
    def expected_batch_size(self) -> float:
        return float(self.batch_size)

    @property
    def steps_per_epoch(self) -> float:
        """Steps per n-example window (fractional when the tail cycles)."""
        return self.n / self.batch_size

    def _perm(self, epoch: int) -> np.ndarray:
        return step_rng(self.seed, epoch, DOMAIN_SHUFFLE).permutation(self.n)

    def at_step(self, k: int) -> np.ndarray:
        k = _check_step("ShuffleSampler", k)
        pos, remaining, out = k * self.batch_size, self.batch_size, []
        while remaining:
            epoch, off = divmod(pos, self.n)
            take = min(remaining, self.n - off)
            out.append(self._perm(epoch)[off:off + take])
            pos += take
            remaining -= take
        return np.concatenate(out) if len(out) > 1 else out[0]

    def __iter__(self) -> Iterator[np.ndarray]:
        t = self.start_step
        while self.steps is None or t < self.start_step + self.steps:
            yield self.at_step(t)
            t += 1


@register_sampler("balls_and_bins", accounting="amplified")
@dataclasses.dataclass
class BallsAndBinsSampler:
    """Balls-and-bins sampling (arxiv 2412.16802): each epoch, every
    example is assigned to one of ``steps_per_epoch`` bins by its own
    independent uniform draw; step ``k`` processes bin ``k mod
    steps_per_epoch`` of epoch ``k // steps_per_epoch``.

    Batch sizes concentrate tightly around ``n / steps_per_epoch`` (fixed
    EXPECTED size — the fixed-shape property shuffling is usually chosen
    for) while the per-example assignment randomness preserves Poisson-like
    amplification, so registration declares ``accounting="amplified"`` and
    the accountant charges the Poisson-subsampled bound at
    ``q = 1 / steps_per_epoch``.

    Counter-based and history-free: epoch ``e``'s full assignment vector is
    a pure function of ``(seed, e)`` under :data:`DOMAIN_BALLS_AND_BINS`.
    """
    n: int
    steps_per_epoch: int
    seed: int = 0
    steps: Optional[int] = None
    start_step: int = 0

    def __post_init__(self):
        if int(self.n) <= 0:
            raise ValueError(f"BallsAndBinsSampler: dataset size n must be "
                             f"positive, got {self.n}")
        if int(self.steps_per_epoch) < 1:
            raise ValueError(f"BallsAndBinsSampler: steps_per_epoch (bins "
                             f"per epoch) must be >= 1, got "
                             f"{self.steps_per_epoch}")

    @classmethod
    def from_rate(cls, *, n: int, q: float, seed: int = 0,
                  steps: Optional[int] = None, start_step: int = 0
                  ) -> "BallsAndBinsSampler":
        _validate_common("BallsAndBinsSampler", n, q)
        return cls(n=n, steps_per_epoch=max(1, round(1.0 / q)), seed=seed,
                   steps=steps, start_step=start_step)

    @property
    def q(self) -> float:
        """Per-example, per-step participation probability (1 / bins)."""
        return 1.0 / self.steps_per_epoch

    @property
    def expected_batch_size(self) -> float:
        return self.n / self.steps_per_epoch

    def _bins(self, epoch: int) -> np.ndarray:
        return step_rng(self.seed, epoch, DOMAIN_BALLS_AND_BINS).integers(
            0, self.steps_per_epoch, size=self.n)

    def at_step(self, k: int) -> np.ndarray:
        k = _check_step("BallsAndBinsSampler", k)
        epoch, b = divmod(k, self.steps_per_epoch)
        return np.nonzero(self._bins(epoch) == b)[0]

    def __iter__(self) -> Iterator[np.ndarray]:
        t = self.start_step
        while self.steps is None or t < self.start_step + self.steps:
            yield self.at_step(t)
            t += 1


@register_sampler("full_batch", accounting="unamplified")
@dataclasses.dataclass
class FullBatchSampler:
    """q = 1 degenerate case: every step processes the whole dataset —
    the bench floor for throughput-at-equal-eps comparisons.  There is no
    subsampling, hence no amplification: ``accounting="unamplified"``
    (at q = 1 the amplified and plain Gaussian bounds coincide, so the
    dispatch is exact, not conservative)."""
    n: int
    seed: int = 0
    steps: Optional[int] = None
    start_step: int = 0

    def __post_init__(self):
        if int(self.n) <= 0:
            raise ValueError(f"FullBatchSampler: dataset size n must be "
                             f"positive, got {self.n}")

    @classmethod
    def from_rate(cls, *, n: int, q: float = 1.0, seed: int = 0,
                  steps: Optional[int] = None, start_step: int = 0
                  ) -> "FullBatchSampler":
        # q is accepted (registry signature) but ignored: full batch IS q=1
        return cls(n=n, seed=seed, steps=steps, start_step=start_step)

    @property
    def q(self) -> float:
        return 1.0

    @property
    def expected_batch_size(self) -> float:
        return float(self.n)

    def at_step(self, k: int) -> np.ndarray:
        _check_step("FullBatchSampler", k)
        return np.arange(self.n)

    def __iter__(self) -> Iterator[np.ndarray]:
        t = self.start_step
        while self.steps is None or t < self.start_step + self.steps:
            yield self.at_step(t)
            t += 1
