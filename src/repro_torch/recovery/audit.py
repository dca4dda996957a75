"""Invariant-audit watchdog: cross-checks the serving stack's books.

Every component with durable state exposes an ``audit()`` contract
returning violation strings (empty == healthy):

* ``OffloadedMoEEngine.audit()`` — slab free-list vs cache accounting,
  slot-map inverse consistency, ghost slots
* ``ModelExpertCache.audit()`` / ``LayerExpertCache.audit()`` —
  capacity, id ranges, score sanity
* ``RequestQueue.audit()`` — arrival conservation, heap order
* ``ServerMetrics.audit()`` — counter sanity
* ``BatchState.audit()`` — slot liveness / duplicate rids

The :class:`Watchdog` runs them all plus the cross-component queue-
conservation law

    arrived + offered_base == finished + shed + expired + pending + in-flight

on a cadence (every N steps / waves) and after every restore. Engine
findings tagged ``drift`` (dict-impl stale residents) are self-healed
via ``resync_slabs()`` and re-checked; anything that survives is
published to ``repro_torch.obs`` as ``audit_violations_total`` and — in
strict mode — raised as :class:`AuditError` (fail fast beats serving
from corrupt state).

Counterpart of ``repro/recovery/audit.py`` (pure Python).
"""
from __future__ import annotations

from typing import List, Optional


class AuditError(RuntimeError):
    """At least one integrity invariant does not hold."""

    def __init__(self, violations: List[str]):
        self.violations = list(violations)
        super().__init__(
            f"{len(self.violations)} invariant violation(s): "
            + "; ".join(self.violations))


class Watchdog:
    """Periodic integrity auditor over one server's components.

    Components are optional — pass whichever exist on this serving
    path. ``offered_base`` offsets the conservation law by the requests
    already resolved before a restore (the rebuilt queue never saw
    them). ``healed_total`` counts slab-drift resyncs.
    """

    def __init__(self, *, queue=None, metrics=None, engine=None, batch=None,
                 offered_base: int = 0, strict: bool = True, registry=None):
        self.queue = queue
        self.metrics = metrics
        self.engine = engine
        self.batch = batch
        self.offered_base = int(offered_base)
        self.strict = strict
        if registry is None:
            from ..obs.registry import REGISTRY as registry
        self.registry = registry
        self.runs = 0
        self.healed_total = 0
        # materialize the series at zero so a green run still exports
        # audit_violations_total == 0 (CI asserts on the sample)
        for comp in ("queue", "metrics", "engine", "batch", "conservation"):
            self._violations_counter(comp).inc(0)
        registry.counter("audit_runs_total", "watchdog audit passes").inc(0)

    def _violations_counter(self, component: str):
        return self.registry.counter(
            "audit_violations_total",
            "invariant violations found by the recovery watchdog",
            component=component)

    # -- the audit pass --------------------------------------------------
    def check(self, in_flight: int = 0) -> List[str]:
        """Run every component audit + the conservation law. Returns the
        surviving violations (after drift self-heal); raises
        :class:`AuditError` in strict mode when any remain."""
        self.runs += 1
        self.registry.counter("audit_runs_total",
                              "watchdog audit passes").inc()
        violations: List[str] = []

        if self.engine is not None:
            findings = self.engine.audit()
            if any(sev == "drift" for sev, _ in findings):
                # recoverable bookkeeping drift: resync the slabs to the
                # cache manager's view, then demand a clean re-audit
                self.healed_total += self.engine.resync_slabs()
                findings = self.engine.audit()
            for sev, msg in findings:
                violations.append(f"engine[{sev}]: {msg}")
                self._violations_counter("engine").inc()

        for comp, obj in (("queue", self.queue), ("metrics", self.metrics),
                          ("batch", self.batch)):
            if obj is None:
                continue
            for msg in obj.audit():
                violations.append(f"{comp}: {msg}")
                self._violations_counter(comp).inc()

        cons = self._conservation(in_flight)
        if cons is not None:
            violations.append(cons)
            self._violations_counter("conservation").inc()

        if violations and self.strict:
            raise AuditError(violations)
        return violations

    def _conservation(self, in_flight: int) -> Optional[str]:
        """Queue-conservation law across queue + metrics + batch."""
        if self.queue is None or self.metrics is None:
            return None
        mt = self.metrics
        arrived = self.queue.arrived_total + self.offered_base
        resolved = (mt.requests_finished + mt.requests_shed
                    + mt.requests_expired)
        accounted = resolved + len(self.queue) + int(in_flight)
        if arrived != accounted:
            return (f"conservation: arrived {arrived} (incl. offered_base="
                    f"{self.offered_base}) != finished {mt.requests_finished}"
                    f" + shed {mt.requests_shed} + expired "
                    f"{mt.requests_expired} + pending {len(self.queue)}"
                    f" + in-flight {int(in_flight)} = {accounted}")
        return None
