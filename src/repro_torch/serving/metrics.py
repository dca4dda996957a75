"""Serving telemetry (a numpy-only copy of ``repro/serving/metrics.py``):
throughput, request-latency percentiles, TTFT /
inter-token latency, queue depth, slot occupancy, and (on the offloaded
path) expert-cache transfers/hit-rate — reported per scheduling policy
so the MELINOE-vs-baseline gap under load is a single JSON diff.

Per-observation series (latencies, queue depth, TTFT, ITL) are rolling
windows of the last ``window`` observations so a long-lived server's
memory does not grow with request count; the aggregate counters
(``requests_finished``, exact queue-depth mean) are cumulative and never
lose history.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ServerMetrics:
    policy: str = "fcfs"
    # rolling-window length for the per-observation series below
    window: int = 4096
    decode_steps: int = 0  # batched decode iterations
    active_row_steps: int = 0  # slot-steps that advanced a live request
    total_row_steps: int = 0  # slot-steps paid for (n_slots * decode_steps)
    prefill_tokens: int = 0
    generated_tokens: int = 0
    wall_time: float = 0.0  # host seconds actually spent serving
    modeled_time: float = 0.0  # Eq. 3 virtual seconds (offloaded path)
    # both Eq.-3 clocks, accumulated side by side on the offloaded path:
    # serial charges compute + every transfer; overlapped hides layer
    # l+1's fetches under layer l's compute (always <= serial)
    modeled_time_serial: float = 0.0
    modeled_time_overlapped: float = 0.0
    # rolling windows (deque(maxlen=window) after __post_init__); appends
    # keep working like lists, old observations fall off the front
    latencies: List[float] = field(default_factory=list)
    queue_depth: List[int] = field(default_factory=list)
    ttfts: List[float] = field(default_factory=list)  # time to first token
    itls: List[float] = field(default_factory=list)  # mean inter-token latency
    # cumulative counterparts that survive window eviction
    requests_finished: int = 0
    queue_depth_sum: float = 0.0
    queue_depth_count: int = 0
    # resilience / SLO accounting (PR 8)
    requests_shed: int = 0  # never admitted: queue bound overflow
    requests_expired: int = 0  # never admitted: SLO passed while queued
    deadline_retired: int = 0  # admitted but cut mid-decode at the SLO
    slo_attained: int = 0  # finished within SLO (or no SLO attached)
    degraded_requests: int = 0  # served >=1 little-expert substitution
    # offloaded-path expert cache accounting
    transfers: int = 0
    transfer_bytes: int = 0
    prefetch_transfers: int = 0
    cache_hits: int = 0
    cache_misses: int = 0

    def __post_init__(self):
        w = max(1, int(self.window))
        self.latencies = deque(self.latencies, maxlen=w)
        self.queue_depth = deque(self.queue_depth, maxlen=w)
        self.ttfts = deque(self.ttfts, maxlen=w)
        self.itls = deque(self.itls, maxlen=w)

    # -- recording ---------------------------------------------------------
    def observe_step(self, n_active: int, n_slots: int, backlog: int) -> None:
        self.decode_steps += 1
        self.active_row_steps += n_active
        self.total_row_steps += n_slots
        self.observe_queue_depth(backlog)

    def observe_queue_depth(self, depth: int) -> None:
        self.queue_depth.append(int(depth))
        self.queue_depth_sum += depth
        self.queue_depth_count += 1

    def observe_finish(self, latency: float, ttft: Optional[float] = None,
                       itl: Optional[float] = None) -> None:
        self.requests_finished += 1
        self.latencies.append(float(latency))
        if ttft is not None:
            self.ttfts.append(float(ttft))
        if itl is not None:
            self.itls.append(float(itl))

    # -- derived -----------------------------------------------------------
    @property
    def occupancy(self) -> float:
        """Mean fraction of slot-steps doing useful work."""
        return self.active_row_steps / self.total_row_steps if self.total_row_steps else 0.0

    @property
    def hit_rate(self) -> float:
        t = self.cache_hits + self.cache_misses
        return self.cache_hits / t if t else 0.0

    @staticmethod
    def _pct(series, p: float) -> float:
        return float(np.percentile(np.asarray(series), p)) if series else 0.0

    def latency_percentile(self, p: float) -> float:
        return self._pct(self.latencies, p)

    @property
    def mean_queue_depth(self) -> float:
        """Exact mean over EVERY observation, not just the window."""
        return (self.queue_depth_sum / self.queue_depth_count
                if self.queue_depth_count else 0.0)

    def throughput_tok_s(self) -> float:
        """Generated tokens per second of serving time — Eq.-3 modeled
        seconds when the offloaded cost model drove the clock, else
        measured wall seconds."""
        t = self.modeled_time if self.modeled_time > 0 else self.wall_time
        return self.generated_tokens / t if t > 0 else 0.0

    @property
    def requests_offered(self) -> int:
        """Everything that entered the system: finished + shed + expired
        (deadline-retired requests are counted in requests_finished)."""
        return self.requests_finished + self.requests_shed + self.requests_expired

    @property
    def slo_attainment(self) -> float:
        """Fraction of offered requests that finished within their SLO
        (best-effort requests count as attained when they finish) — the
        chaos benchmark's goodput numerator."""
        total = self.requests_offered
        return self.slo_attained / total if total else 0.0

    def goodput_req_s(self) -> float:
        """SLO-attained requests per second of serving time."""
        t = self.modeled_time if self.modeled_time > 0 else self.wall_time
        return self.slo_attained / t if t > 0 else 0.0

    # -- durable state (recovery checkpoints) -------------------------------
    def to_state(self) -> Dict:
        """Plain-python snapshot of every counter and rolling window —
        the ServerMetrics entry in a recovery checkpoint."""
        out = {}
        for f in fields(self):
            val = getattr(self, f.name)
            out[f.name] = list(val) if isinstance(val, deque) else val
        return out

    @classmethod
    def from_state(cls, state: Dict) -> "ServerMetrics":
        """Rebuild from :meth:`to_state` output. Unknown keys are
        ignored so old checkpoints survive field additions."""
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in state.items() if k in known})

    def audit(self) -> List[str]:
        """Counter-sanity check (watchdog contract): non-negative
        cumulative counters and window/aggregate agreement. Returns
        violation strings, empty when healthy."""
        v = []
        for name in ("decode_steps", "prefill_tokens", "generated_tokens",
                     "requests_finished", "requests_shed", "requests_expired",
                     "deadline_retired", "slo_attained", "degraded_requests",
                     "transfers", "transfer_bytes", "cache_hits",
                     "cache_misses"):
            if getattr(self, name) < 0:
                v.append(f"negative counter {name}={getattr(self, name)}")
        if self.slo_attained > self.requests_finished:
            v.append(f"slo_attained={self.slo_attained} > "
                     f"requests_finished={self.requests_finished}")
        if self.deadline_retired > self.requests_finished:
            v.append(f"deadline_retired={self.deadline_retired} > "
                     f"requests_finished={self.requests_finished}")
        if len(self.latencies) > self.requests_finished:
            v.append(f"latency window {len(self.latencies)} > "
                     f"requests_finished={self.requests_finished}")
        if self.queue_depth_count < len(self.queue_depth):
            v.append(f"queue_depth_count={self.queue_depth_count} < "
                     f"window {len(self.queue_depth)}")
        return v

    def summary(self) -> Dict:
        return {
            "policy": self.policy,
            "requests": self.requests_finished,
            "decode_steps": self.decode_steps,
            "generated_tokens": self.generated_tokens,
            "prefill_tokens": self.prefill_tokens,
            "throughput_tok_s": self.throughput_tok_s(),
            "latency_p50": self.latency_percentile(50),
            "latency_p95": self.latency_percentile(95),
            "latency_p99": self.latency_percentile(99),
            "ttft_p50": self._pct(self.ttfts, 50),
            "ttft_p95": self._pct(self.ttfts, 95),
            "itl_p50": self._pct(self.itls, 50),
            "itl_p95": self._pct(self.itls, 95),
            "mean_queue_depth": self.mean_queue_depth,
            "slot_occupancy": self.occupancy,
            "wall_time_s": self.wall_time,
            "modeled_time_s": self.modeled_time,
            # service-time-only clocks (no virtual idle between arrivals),
            # so serial vs overlapped compare like for like
            "modeled_time_serial_s": self.modeled_time_serial,
            "modeled_time_overlapped_s": self.modeled_time_overlapped,
            "service_throughput_serial_tok_s": (
                self.generated_tokens / self.modeled_time_serial
                if self.modeled_time_serial > 0 else 0.0
            ),
            "service_throughput_overlapped_tok_s": (
                self.generated_tokens / self.modeled_time_overlapped
                if self.modeled_time_overlapped > 0 else 0.0
            ),
            "transfers": self.transfers,
            "transfer_bytes": self.transfer_bytes,
            "prefetch_transfers": self.prefetch_transfers,
            "cache_hit_rate": self.hit_rate,
            "requests_shed": self.requests_shed,
            "requests_expired": self.requests_expired,
            "deadline_retired": self.deadline_retired,
            "degraded_requests": self.degraded_requests,
            "slo_attained": self.slo_attained,
            "slo_attainment": self.slo_attainment,
            "goodput_req_s": self.goodput_req_s(),
        }

    def publish(self, registry=None, **labels) -> None:
        """Export the summary as ``serve_*`` gauges: needs the metrics
        registry of ``obs/``, which is not ported yet."""
        raise NotImplementedError("ServerMetrics.publish needs obs/, not ported yet")
