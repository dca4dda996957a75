"""Request queue + synthetic traffic generation (a numpy-only copy of
``repro/serving/queue.py``, over the port's own ``data/synthetic.py``).

Arrivals are simulated on a virtual clock (seconds). ``poisson`` draws
i.i.d. exponential inter-arrival gaps at ``rate`` req/s; ``bursty``
releases requests in bursts of ``burst_size`` (the adversarial case for
an affinity scheduler: a burst mixes clusters); ``all_at_once`` puts the
whole workload at t=0 (closed-loop saturation benchmarks).

Prompts are drawn from the ``ClusterLM`` distribution so the workload
carries the latent cluster structure MELINOE exploits: same-cluster
requests share token pools, hence routing, hence cacheable expert sets.
"""
from __future__ import annotations

from bisect import insort
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data.synthetic import ClusterLM
from .request import ServeRequest

_ORDER = lambda r: (r.arrival_time, r.rid)


class RequestQueue:
    """Arrival-ordered pending pool; the scheduler picks admission order.

    ``max_pending`` bounds the *arrived-but-unadmitted* backlog
    (admission control): a pre-synthesized trace's future arrivals are
    not in the system yet, so they never count against the bound — the
    server calls :meth:`enforce_bound` with its clock each loop, and
    live :meth:`push` enforces it immediately. Victims are always the
    latest arrivals; they collect in :attr:`shed` until a server drains
    them into "shed" results. An unbounded queue (the default) never
    sheds.
    """

    def __init__(self, requests: Sequence[ServeRequest] = (),
                 max_pending: Optional[int] = None):
        self.max_pending = None
        self.shed: List[ServeRequest] = []
        self.shed_count = 0
        self._pending: List[ServeRequest] = sorted(requests, key=_ORDER)
        # conservation counters: every request that ever entered the
        # queue is pending, admitted, or shed — the invariant the
        # recovery watchdog audits live
        self.arrived_total = len(self._pending)
        self.admitted_total = 0
        self.drained_total = 0
        self.set_bound(max_pending)

    def set_bound(self, max_pending: Optional[int]) -> None:
        """(Re)set the admission bound; takes effect at the next
        :meth:`enforce_bound` / :meth:`push`, so a server can tighten it
        at run start without instantly shedding a whole offline trace."""
        assert max_pending is None or max_pending > 0, max_pending
        self.max_pending = max_pending

    def enforce_bound(self, now: float) -> List[ServeRequest]:
        """Shed the latest-arrived ready requests beyond ``max_pending``
        — the backlog a bounded server refuses to let build up."""
        if self.max_pending is None:
            return []
        over = self.ready(now)[self.max_pending:]
        if over:
            # one O(n) pass keyed on identity — `r not in over` would
            # rescan the victim list per pending request (O(n*m))
            drop = {id(r) for r in over}
            self._pending = [r for r in self._pending if id(r) not in drop]
            self._shed(over)
        return over

    def _shed(self, reqs: Sequence[ServeRequest]) -> None:
        self.shed.extend(reqs)
        self.shed_count += len(reqs)

    def push(self, req: ServeRequest) -> bool:
        """Insert in arrival order (stable for out-of-order pushes).
        Returns False when the bound forces a shed — of the latest
        arrival, which may be ``req`` itself."""
        insort(self._pending, req, key=_ORDER)
        self.arrived_total += 1
        if self.max_pending is not None and len(self._pending) > self.max_pending:
            victim = self._pending.pop()
            self._shed([victim])
            return False
        return True

    def drop_expired(self, now: float) -> List[ServeRequest]:
        """Shed every pending request whose SLO deadline has already
        passed — admitting it could only produce a deadline miss."""
        expired = [r for r in self._pending
                   if r.deadline is not None and r.deadline <= now]
        if expired:
            drop = {id(r) for r in expired}
            self._pending = [r for r in self._pending if id(r) not in drop]
            self._shed(expired)
        return expired

    def drain_shed(self) -> List[ServeRequest]:
        """Hand the accumulated shed requests to the caller (once)."""
        out, self.shed = self.shed, []
        self.drained_total += len(out)
        return out

    def ready(self, now: float) -> List[ServeRequest]:
        """Requests that have arrived and are not yet admitted."""
        return [r for r in self._pending if r.arrival_time <= now]

    def pending(self) -> List[ServeRequest]:
        """Snapshot of the pending pool in arrival order (checkpointing
        and journal replay read this; mutation stays internal)."""
        return list(self._pending)

    def admit(self, req: ServeRequest) -> None:
        """Move ``req`` from pending to in-service. Raises ``KeyError``
        when it is not pending — the scheduler raced a shed/expiry (the
        first failure mode journal replay hits), or it was admitted
        twice."""
        try:
            self._pending.remove(req)
        except ValueError:
            raise KeyError(
                f"request rid={req.rid} is not pending (concurrently "
                f"shed/expired, or already admitted)") from None
        self.admitted_total += 1

    def next_arrival(self) -> Optional[float]:
        return self._pending[0].arrival_time if self._pending else None

    def backlog(self, now: float) -> int:
        """Queue depth: arrived but not yet admitted."""
        return len(self.ready(now))

    def __len__(self) -> int:
        return len(self._pending)

    def audit(self) -> List[str]:
        """Internal-consistency check (watchdog contract): returns a
        list of violation strings, empty when healthy."""
        v = []
        accounted = len(self._pending) + self.admitted_total + self.shed_count
        if self.arrived_total != accounted:
            v.append(
                f"queue conservation: arrived_total={self.arrived_total} != "
                f"pending={len(self._pending)} + admitted={self.admitted_total}"
                f" + shed={self.shed_count}")
        if self.shed_count != self.drained_total + len(self.shed):
            v.append(
                f"shed accounting: shed_count={self.shed_count} != "
                f"drained={self.drained_total} + undrained={len(self.shed)}")
        if any(_ORDER(a) > _ORDER(b)
               for a, b in zip(self._pending, self._pending[1:])):
            v.append("pending pool out of arrival order")
        return v


@dataclass(frozen=True)
class TrafficConfig:
    n_requests: int = 16
    arrival: str = "poisson"  # "poisson" | "bursty" | "all_at_once"
    rate: float = 4.0  # mean arrival rate, requests / virtual second
    burst_size: int = 4
    prompt_len: Tuple[int, int] = (8, 32)  # inclusive range
    max_new_tokens: Tuple[int, int] = (4, 32)  # inclusive range
    temperature: float = 0.0
    stop_tokens: Tuple[int, ...] = ()
    n_clusters: Optional[int] = None  # restrict to the first k clusters
    slo: Optional[float] = None  # per-request SLO (virtual s); None = best effort
    quality: float = 1.0  # little-expert quality dial (1.0 = always exact)
    seed: int = 0


def synthesize_workload(lm: ClusterLM, tcfg: TrafficConfig) -> List[ServeRequest]:
    """Sample a request trace over the ClusterLM prompt distribution."""
    rng = np.random.default_rng(tcfg.seed)
    n = tcfg.n_requests

    if tcfg.arrival == "poisson":
        gaps = rng.exponential(1.0 / max(tcfg.rate, 1e-9), n)
        arrivals = np.cumsum(gaps)
    elif tcfg.arrival == "bursty":
        burst_gap = tcfg.burst_size / max(tcfg.rate, 1e-9)
        arrivals = np.asarray([(i // tcfg.burst_size) * burst_gap for i in range(n)])
    elif tcfg.arrival == "all_at_once":
        arrivals = np.zeros(n)
    else:
        raise ValueError(f"unknown arrival process: {tcfg.arrival!r}")

    k_max = tcfg.n_clusters or lm.cfg.n_clusters
    reqs = []
    for i in range(n):
        cluster = int(rng.integers(k_max))
        plen = int(rng.integers(tcfg.prompt_len[0], tcfg.prompt_len[1] + 1))
        seq, _ = lm.sample_sequence(rng, cluster=cluster)
        prompt = seq[:plen].astype(np.int32)
        max_new = int(rng.integers(tcfg.max_new_tokens[0], tcfg.max_new_tokens[1] + 1))
        reqs.append(
            ServeRequest(
                rid=i,
                prompt=prompt,
                max_new_tokens=max_new,
                temperature=tcfg.temperature,
                stop_tokens=tcfg.stop_tokens,
                arrival_time=float(arrivals[i]),
                cluster=cluster,
                slo=tcfg.slo,
                quality=tcfg.quality,
            )
        )
    return reqs
