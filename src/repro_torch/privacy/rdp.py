"""RDP accountant for the Poisson-subsampled Gaussian mechanism.

Implements the moments-accountant bound of Abadi et al. (2016) in the RDP
formulation of Mironov (2017) / Mironov, Talwar & Zhang (2019):

For integer alpha >= 2, the RDP of the subsampled Gaussian with sampling rate
q and noise multiplier sigma is

    RDP(alpha) = 1/(alpha-1) * log( sum_{k=0}^{alpha} C(alpha,k)
                     (1-q)^(alpha-k) q^k exp(k(k-1)/(2 sigma^2)) )

(log-space binomial series, numerically stable).  Composition over T steps is
additive in RDP.  Conversion to (eps, delta)-DP uses the improved bound of
Balle et al. (2020) / Canonne-Kamath-Steinke:

    eps(delta) = RDP(alpha) + log((alpha-1)/alpha) - (log delta + log alpha)/(alpha-1)

minimised over the alpha grid.  Pure numpy — no jax dependency, usable on the
host side of the training loop.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

DEFAULT_ALPHAS: Sequence[float] = tuple(range(2, 65)) + (128.0, 256.0, 512.0)


def _log_comb(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _logsumexp(xs: Iterable[float]) -> float:
    xs = list(xs)
    m = max(xs)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(x - m) for x in xs))


def rdp_subsampled_gaussian(q: float, sigma: float, alpha: float) -> float:
    """RDP(alpha) of one step of the Poisson-subsampled Gaussian."""
    if q == 0:
        return 0.0
    if sigma == 0:
        return math.inf
    if q == 1.0:
        return alpha / (2 * sigma ** 2)
    if float(alpha).is_integer() and alpha >= 2:
        a = int(alpha)
        terms = [
            _log_comb(a, k) + (a - k) * math.log1p(-q) + k * math.log(q)
            + (k * k - k) / (2 * sigma ** 2)
            for k in range(a + 1)
        ]
        return max(_logsumexp(terms), 0.0) / (alpha - 1)
    # Fractional alpha: sandwich between the neighbouring integers (the RDP
    # curve is convex in alpha, so linear interpolation upper-bounds it only
    # between integer points where it is evaluated exactly; we use the
    # conservative max of the two neighbours' slopes via convexity).
    lo, hi = int(math.floor(alpha)), int(math.ceil(alpha))
    lo = max(lo, 2)
    hi = max(hi, lo + 1)
    rlo = rdp_subsampled_gaussian(q, sigma, lo) * (lo - 1)
    rhi = rdp_subsampled_gaussian(q, sigma, hi) * (hi - 1)
    t = (alpha - lo) / (hi - lo)
    return ((1 - t) * rlo + t * rhi) / (alpha - 1)


def rdp_gaussian(sigma: float, alpha: float) -> float:
    """RDP(alpha) of one UNAMPLIFIED Gaussian mechanism step (no
    subsampling): alpha / (2 sigma^2).  This is the bound that is actually
    valid for samplers without per-step subsampling randomness (shuffling,
    full batch) — shuffled composition does NOT enjoy the Poisson-subsampled
    bound (arxiv 2411.04205)."""
    if sigma == 0:
        return math.inf
    return alpha / (2 * sigma ** 2)


def compose(q: float, sigma: float, steps: int,
            alphas: Sequence[float] = DEFAULT_ALPHAS) -> np.ndarray:
    return np.array([steps * rdp_subsampled_gaussian(q, sigma, a)
                     for a in alphas])


def compose_for(sampler_kind: str, q: float, sigma: float, steps: int,
                alphas: Sequence[float] = DEFAULT_ALPHAS) -> np.ndarray:
    """Per-sampler RDP composition: dispatch on the ``accounting`` trait the
    sampler declared at registration (:mod:`repro_torch.data.sampler`).

    ``"amplified"`` samplers (poisson; balls_and_bins per its amplification
    theorem, arxiv 2412.16802) get the Poisson-subsampled Gaussian bound at
    their effective rate ``q``; ``"unamplified"`` samplers (shuffle,
    full_batch) get the plain Gaussian bound — the shortcut's TRUE cost,
    visible instead of silently mis-accounted.  Unknown kinds fail with the
    registry's helpful error.
    """
    from ..data.sampler import sampler_accounting
    if sampler_accounting(sampler_kind) == "amplified":
        return compose(q, sigma, steps, alphas)
    return np.array([steps * rdp_gaussian(sigma, a) for a in alphas])


def rdp_to_eps(rdp: np.ndarray, delta: float,
               alphas: Sequence[float] = DEFAULT_ALPHAS) -> float:
    """Tight RDP -> (eps, delta) conversion (CKS / Balle et al.)."""
    best = math.inf
    for r, a in zip(rdp, alphas):
        if a <= 1 or math.isinf(r):
            continue
        eps = r + math.log1p(-1 / a) - (math.log(delta) + math.log(a)) / (a - 1)
        best = min(best, eps)
    return max(best, 0.0)


def epsilon(q: float, sigma: float, steps: int, delta: float,
            alphas: Sequence[float] = DEFAULT_ALPHAS) -> float:
    return rdp_to_eps(compose(q, sigma, steps, alphas), delta, alphas)


def epsilon_for(sampler_kind: str, q: float, sigma: float, steps: int,
                delta: float, alphas: Sequence[float] = DEFAULT_ALPHAS
                ) -> float:
    """(eps, delta) spend of ``steps`` steps under the bound that is VALID
    for ``sampler_kind`` (see :func:`compose_for`)."""
    return rdp_to_eps(compose_for(sampler_kind, q, sigma, steps, alphas),
                      delta, alphas)


def calibrate_sigma(target_eps: float, q: float, steps: int, delta: float,
                    lo: float = 0.3, hi: float = 64.0, tol: float = 1e-4,
                    sampler: str = "poisson") -> float:
    """Smallest sigma achieving eps <= target_eps, by bisection, under the
    bound valid for ``sampler`` — calibrating a shortcut sampler against
    the amplified bound would under-noise it."""
    def eps(sigma):
        return epsilon_for(sampler, q, sigma, steps, delta)
    if eps(hi) > target_eps:
        raise ValueError("target eps unreachable with sigma <= hi")
    while eps(lo) <= target_eps and lo > 1e-3:
        lo /= 2
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if eps(mid) <= target_eps:
            hi = mid
        else:
            lo = mid
        if hi - lo < tol:
            break
    return hi
