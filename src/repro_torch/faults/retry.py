"""Retry/backoff policy for the engine's host-transfer seam (a copy of
``repro/faults/retry.py``).

A fetch attempt that the :class:`~repro_torch.faults.plan.FaultPlan` fails is
retried under a :class:`FetchPolicy`: bounded attempts with exponential
backoff, all charged to the *modeled* clock (the failed DMA burned real
link time; the backoff is deliberate idle). When retries or the
per-fetch deadline are exhausted the engine degrades to the little
expert instead of raising — unless no little bank exists, in which case
it keeps retrying (the "no-resilience baseline" the chaos benchmark
measures against), up to ``hard_cap`` as a runaway guard.
"""
from __future__ import annotations

from dataclasses import dataclass

_MASK64 = 0xFFFFFFFFFFFFFFFF


def _unit_hash(*keys: int) -> float:
    """Deterministic stateless hash of integer keys onto [0, 1).
    splitmix64-style mixing: stable across processes and Python runs
    (unlike ``hash``), with no Generator state to thread through the
    frozen policy."""
    h = 0x9E3779B97F4A7C15
    for k in keys:
        h ^= ((int(k) & _MASK64) + 0x9E3779B97F4A7C15
              + ((h << 6) & _MASK64) + (h >> 2)) & _MASK64
        h &= _MASK64
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & _MASK64
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & _MASK64
    h ^= h >> 31
    return h / 2.0 ** 64


@dataclass(frozen=True)
class FetchPolicy:
    """Per-expert-fetch retry budget.

    ``max_retries < 0`` means unbounded (still capped at ``hard_cap``
    attempts as a safety net against a 100%-failure plan wedging the
    no-degrade baseline forever).
    """

    max_retries: int = 3
    backoff_base_s: float = 1e-4
    backoff_mult: float = 2.0
    backoff_cap_s: float = 5e-3
    # give up on a single expert fetch once its attempts have consumed
    # this much modeled time (None = no per-fetch deadline)
    fetch_deadline_s: float | None = None
    hard_cap: int = 1000
    # deterministic seeded jitter: each backoff is scaled by a factor
    # drawn from [1 - jitter_frac, 1], keyed on (seed, salt, attempt).
    # N restarted workers that pass distinct salts (their worker index)
    # decorrelate instead of retrying in lockstep after a shared
    # failure. 0.0 (the default, and NAIVE_POLICY) = exact exponential.
    jitter_frac: float = 0.0
    seed: int = 0

    def backoff(self, attempt: int, salt: int = 0) -> float:
        """Modeled idle seconds before retry ``attempt`` (0-based)."""
        base = min(self.backoff_base_s * (self.backoff_mult ** attempt),
                   self.backoff_cap_s)
        if self.jitter_frac <= 0.0 or base <= 0.0:
            return base
        u = _unit_hash(self.seed, salt, attempt)
        return base * (1.0 - self.jitter_frac * u)

    def attempts_allowed(self, attempt: int, spent_s: float) -> bool:
        """May we make attempt number ``attempt`` (0-based) after having
        spent ``spent_s`` modeled seconds on this fetch so far?"""
        if attempt >= self.hard_cap:
            return False
        if self.max_retries >= 0 and attempt > self.max_retries:
            return False
        if self.fetch_deadline_s is not None and spent_s >= self.fetch_deadline_s:
            return False
        return True


NAIVE_POLICY = FetchPolicy(max_retries=-1, backoff_base_s=0.0,
                           backoff_mult=1.0, backoff_cap_s=0.0,
                           fetch_deadline_s=None)
