"""Seedable, deterministic fault injection for the offloaded stack (a
numpy-only copy of ``repro/faults/plan.py``: the same spec, the same
``np.random.default_rng(seed)`` draws in the same call order).

MELINOE's premise is that the expert transfer is the fragile resource:
a production deployment sees DMA latency spikes, transient fetch
failures, cache-thrashing interference, and traffic bursts ("Towards
MoE Deployment", Huang et al.). A :class:`FaultPlan` injects exactly
those events at the engine's host-transfer seam
(``OffloadedMoEEngine._guard_fetch`` / ``_guard_prefetch``) and at the
servers' virtual clocks, so the resilience layer (retry/backoff,
little-expert degraded mode, SLO shedding) can be exercised and
benchmarked deterministically.

Design mirrors ``obs.trace``:

* **Zero cost when disabled.** The module global defaults to
  :data:`NULL_FAULT_PLAN`; hot paths guard on ``plan.enabled`` (one
  attribute load) and never construct arguments for a disabled plan.
* **Deterministic.** All draws come from one ``np.random.Generator``
  seeded by the config; the same plan over the same call sequence
  replays the same faults, so chaos benchmarks race configurations
  under the *identical* fault trace.
* **Env-driven.** ``REPRO_FAULTS="fail=0.1,spike=0.05:2e-3,seed=7"``
  installs a plan at import time for any entry point; ``rate:magnitude``
  pairs are colon-separated.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np

from ..obs.trace import get_tracer


@dataclass(frozen=True)
class FaultConfig:
    """Intensities for each injected fault class (all default off)."""

    seed: int = 0
    # transient host->device fetch failures: each transfer attempt fails
    # with this probability (retried by the engine's FetchPolicy)
    fetch_fail_rate: float = 0.0
    # transfer latency spikes: each successful transfer is delayed by
    # spike_s extra modeled seconds with probability spike_rate
    spike_rate: float = 0.0
    spike_s: float = 0.0
    # eviction storms: once per engine step with probability storm_rate,
    # a storm_frac fraction of every layer's residents is evicted
    # (interference from a co-tenant thrashing device memory)
    storm_rate: float = 0.0
    storm_frac: float = 0.5
    # server clock stalls: each decode step is delayed by step_delay_s
    # virtual seconds with probability step_delay_rate (GC pause /
    # noisy-neighbor interference on the serving host)
    step_delay_rate: float = 0.0
    step_delay_s: float = 0.0
    # traffic bursts: compress_arrivals squeezes each request's arrival
    # toward the start of its burst window by this fraction (0 = leave
    # the trace alone, 1 = every window collapses to a simultaneous
    # burst), over windows of burst_window requests
    burst_compress: float = 0.0
    burst_window: int = 8
    # process crashes: each crash point (one per decode step in the
    # engine and the continuous server) raises InjectedCrash with
    # probability crash_rate, or deterministically on exactly the
    # crash_at-th point (1-based; 0 = off) — the kill half of the
    # kill -> restore -> replay chaos loop
    crash_rate: float = 0.0
    crash_at: int = 0
    # worker-level faults for the fleet supervisor. kill: a hard
    # process exit mid-step (os._exit — no unwinding, no journal close,
    # indistinguishable from SIGKILL), with probability kill_rate per
    # worker step hook or deterministically at the kill_at-th hook.
    # hang: the worker goes silent (no heartbeat, no progress) for
    # hang_s wall seconds while the process stays alive, so only the
    # supervisor's heartbeat-staleness deadline — not process exit —
    # can detect it.
    kill_rate: float = 0.0
    kill_at: int = 0
    hang_rate: float = 0.0
    hang_s: float = 0.0
    hang_at: int = 0

    @property
    def any_active(self) -> bool:
        return any(r > 0 for r in (
            self.fetch_fail_rate, self.spike_rate, self.storm_rate,
            self.step_delay_rate, self.burst_compress, self.crash_rate,
            self.crash_at, self.kill_rate, self.kill_at, self.hang_rate,
            self.hang_at))


_SPEC_KEYS = {
    "seed": ("seed",),
    "fail": ("fetch_fail_rate",),
    "spike": ("spike_rate", "spike_s"),
    "storm": ("storm_rate", "storm_frac"),
    "step_delay": ("step_delay_rate", "step_delay_s"),
    "burst": ("burst_compress", "burst_window"),
    "crash": ("crash_rate",),
    "crash_at": ("crash_at",),
    "kill": ("kill_rate",),
    "kill_at": ("kill_at",),
    "hang": ("hang_rate", "hang_s"),
    "hang_at": ("hang_at", "hang_s"),
}


class InjectedCrash(RuntimeError):
    """Simulated process death raised at a fault-plan crash point. The
    serving stack deliberately does NOT catch it — it unwinds like a
    kill so recovery tests exercise the journal/restore path for real."""


def parse_fault_spec(spec: str) -> FaultConfig:
    """``"fail=0.1,spike=0.05:2e-3,storm=0.02:0.5,seed=7"`` ->
    :class:`FaultConfig`. Unknown keys raise so typos never silently
    disable a chaos run."""
    cfg = FaultConfig()
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        key, _, val = item.partition("=")
        key = key.strip()
        if key not in _SPEC_KEYS:
            raise ValueError(
                f"unknown fault key {key!r}; options: {sorted(_SPEC_KEYS)}")
        fields = _SPEC_KEYS[key]
        parts = val.split(":")
        if len(parts) > len(fields):
            raise ValueError(f"too many values for {key!r}: {val!r}")
        updates = {}
        for f, p in zip(fields, parts):
            cur = getattr(cfg, f)
            updates[f] = type(cur)(float(p)) if isinstance(cur, int) \
                else float(p)
        cfg = replace(cfg, **updates)
    return cfg


class FaultPlan:
    """Live fault injector. Every draw is counted (``counters``) and,
    when tracing is enabled, emitted as a ``fault.*`` instant so chaos
    traces show where each injected event landed."""

    enabled = True

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self.counters: Dict[str, int] = {
            "fetch_fail": 0, "spike": 0, "storm": 0, "step_delay": 0,
            "crash": 0, "kill": 0, "hang": 0,
        }
        self._crash_calls = 0
        self._kill_calls = 0
        self._hang_calls = 0

    # -- draws (one per potential event; deterministic in call order) ----
    def fetch_fails(self, moe_idx: int = -1) -> bool:
        """One host->device transfer attempt: does it transiently fail?"""
        c = self.cfg
        if c.fetch_fail_rate <= 0.0:
            return False
        if self._rng.random() >= c.fetch_fail_rate:
            return False
        self.counters["fetch_fail"] += 1
        tr = get_tracer()
        if tr.enabled:
            tr.instant("fault.fetch_fail", layer=moe_idx)
        return True

    def transfer_spike(self, moe_idx: int = -1) -> float:
        """Extra modeled seconds of DMA latency for one transfer."""
        c = self.cfg
        if c.spike_rate <= 0.0 or self._rng.random() >= c.spike_rate:
            return 0.0
        self.counters["spike"] += 1
        tr = get_tracer()
        if tr.enabled:
            tr.instant("fault.spike", layer=moe_idx, extra_s=c.spike_s)
        return c.spike_s

    def eviction_storm(self) -> float:
        """Per engine step: fraction of residents to evict (0 = calm)."""
        c = self.cfg
        if c.storm_rate <= 0.0 or self._rng.random() >= c.storm_rate:
            return 0.0
        self.counters["storm"] += 1
        tr = get_tracer()
        if tr.enabled:
            tr.instant("fault.storm", frac=c.storm_frac)
        return c.storm_frac

    def storm_victims(self, residents, frac: float) -> List[int]:
        """Deterministic victim pick for one layer of an eviction storm."""
        residents = sorted(residents)
        k = int(round(len(residents) * frac))
        if k <= 0:
            return []
        pick = self._rng.choice(len(residents), size=k, replace=False)
        return [residents[i] for i in pick]

    def step_delay(self) -> float:
        """Extra virtual seconds injected into one server decode step."""
        c = self.cfg
        if c.step_delay_rate <= 0.0 or self._rng.random() >= c.step_delay_rate:
            return 0.0
        self.counters["step_delay"] += 1
        tr = get_tracer()
        if tr.enabled:
            tr.instant("fault.step_delay", extra_s=c.step_delay_s)
        return c.step_delay_s

    def maybe_crash(self, where: str = "") -> None:
        """One crash point. Raises :class:`InjectedCrash` on the
        ``crash_at``-th call (deterministic kill) or with probability
        ``crash_rate`` (random kills for the sweep); otherwise a no-op.
        Call points are counted across engine and server alike, so
        ``crash_at=K`` lands at the same spot on every identical run."""
        c = self.cfg
        if c.crash_at <= 0 and c.crash_rate <= 0.0:
            return
        self._crash_calls += 1
        hit = self._crash_calls == c.crash_at
        if not hit and c.crash_rate > 0.0:
            hit = self._rng.random() < c.crash_rate
        if not hit:
            return
        self.counters["crash"] += 1
        tr = get_tracer()
        if tr.enabled:
            tr.instant("fault.crash", call=self._crash_calls, where=where)
        raise InjectedCrash(
            f"injected crash at point {self._crash_calls}"
            + (f" ({where})" if where else ""))

    def maybe_kill(self, where: str = "") -> bool:
        """One worker kill point (the fleet worker's step hook). Returns
        True when the process must hard-exit NOW; the caller performs
        the ``os._exit`` so unit tests can observe the verdict without
        dying. Counted separately from crash points, and short-circuited
        before any rng draw when off, so a pure worker-fault spec never
        perturbs the engine-fault stream."""
        c = self.cfg
        if c.kill_at <= 0 and c.kill_rate <= 0.0:
            return False
        self._kill_calls += 1
        hit = self._kill_calls == c.kill_at
        if not hit and c.kill_rate > 0.0:
            hit = self._rng.random() < c.kill_rate
        if not hit:
            return False
        self.counters["kill"] += 1
        tr = get_tracer()
        if tr.enabled:
            tr.instant("fault.kill", call=self._kill_calls, where=where)
        return True

    def maybe_hang(self) -> float:
        """Wall seconds the worker should go silent at this step hook
        (no heartbeat, no progress — the process stays alive). 0.0 =
        keep running. The hang is what distinguishes the supervisor's
        staleness detector from plain exit-code watching."""
        c = self.cfg
        if c.hang_at <= 0 and c.hang_rate <= 0.0:
            return 0.0
        self._hang_calls += 1
        hit = self._hang_calls == c.hang_at
        if not hit and c.hang_rate > 0.0:
            hit = self._rng.random() < c.hang_rate
        if not hit:
            return 0.0
        self.counters["hang"] += 1
        tr = get_tracer()
        if tr.enabled:
            tr.instant("fault.hang", call=self._hang_calls, hang_s=c.hang_s)
        return c.hang_s

    # -- workload shaping ------------------------------------------------
    def compress_arrivals(self, requests) -> None:
        """Traffic bursts: within each window of ``burst_window``
        consecutive requests, pull every arrival toward the window's
        first arrival by ``burst_compress`` (in place, order preserved —
        arrivals within a window share a start, so compression never
        reorders the trace)."""
        c = self.cfg
        if c.burst_compress <= 0.0:
            return
        reqs = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
        for i in range(0, len(reqs), max(c.burst_window, 1)):
            window = reqs[i:i + max(c.burst_window, 1)]
            t0 = window[0].arrival_time
            for r in window:
                r.arrival_time = t0 + (r.arrival_time - t0) * (
                    1.0 - c.burst_compress)

    # -- obs -------------------------------------------------------------
    def publish(self, registry=None) -> None:
        """Export injected-event counts as ``fault_injected_total``
        gauges labeled by kind (global registry by default)."""
        if registry is None:
            from ..obs.registry import REGISTRY as registry
        for kind, n in self.counters.items():
            registry.gauge("fault_injected_total",
                           "events injected by the active FaultPlan",
                           kind=kind).set(n)


class NullFaultPlan:
    """Disabled injection: every hook is a no-op returning the benign
    value. ``enabled`` is a class attribute, so the hot-path guard is a
    single attribute load (NullTracer-style)."""

    enabled = False
    cfg = FaultConfig()
    counters: Dict[str, int] = {}

    def fetch_fails(self, moe_idx: int = -1) -> bool:
        return False

    def transfer_spike(self, moe_idx: int = -1) -> float:
        return 0.0

    def eviction_storm(self) -> float:
        return 0.0

    def storm_victims(self, residents, frac: float) -> List[int]:
        return []

    def step_delay(self) -> float:
        return 0.0

    def maybe_crash(self, where: str = "") -> None:
        pass

    def maybe_kill(self, where: str = "") -> bool:
        return False

    def maybe_hang(self) -> float:
        return 0.0

    def compress_arrivals(self, requests) -> None:
        pass

    def publish(self, registry=None) -> None:
        pass


NULL_FAULT_PLAN = NullFaultPlan()
_plan = NULL_FAULT_PLAN

ENV_VAR = "REPRO_FAULTS"


def get_fault_plan():
    """The active plan — :data:`NULL_FAULT_PLAN` unless one was
    installed. Hot paths hold the result once per step and guard bulk
    work on ``.enabled``."""
    return _plan


def install_fault_plan(cfg_or_spec) -> FaultPlan:
    """Install (and return) a fresh :class:`FaultPlan` as the global.
    Accepts a :class:`FaultConfig` or a spec string."""
    global _plan
    cfg = (parse_fault_spec(cfg_or_spec)
           if isinstance(cfg_or_spec, str) else cfg_or_spec)
    _plan = FaultPlan(cfg)
    return _plan


def uninstall_fault_plan() -> None:
    global _plan
    _plan = NULL_FAULT_PLAN


def fault_plan_from_env() -> Optional[FaultPlan]:
    """Install a plan from ``REPRO_FAULTS`` if set (any entry point)."""
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return None
    return install_fault_plan(spec)


fault_plan_from_env()
