"""Pluggable admission schedulers (a copy of ``repro/serving/scheduler.py``).

``order(ready, hot=...)`` returns the ready requests in admission
order; the server takes as many off the front as it has capacity for.
``hot`` is the set of requests whose experts are currently resident
(active slots / previous wave) — only the affinity policy looks at it.

* ``fcfs``            — arrival order (the latency-fair baseline)
* ``sjf``             — shortest job first by prompt+budget token work
* ``expert-affinity`` — greedy chaining by predicted expert-set overlap
  (Eq. 7 Top-C sets): each pick maximizes overlap with the experts
  already hot (active requests / previous wave), so co-scheduled
  sequences share the resident cache and CPU<->GPU transfers stay at the
  Eq. 3 floor. This is the serving-side analogue of MELINOE's
  fine-tuned routing concentration: the smaller and more cluster-stable
  the per-request expert sets, the more the scheduler can exploit them.
"""
from __future__ import annotations

from typing import List, Sequence

from .request import ServeRequest


class Scheduler:
    name = "base"

    def order(self, ready: Sequence[ServeRequest], *,
              hot: Sequence[ServeRequest] = ()) -> List[ServeRequest]:
        raise NotImplementedError


class FCFSScheduler(Scheduler):
    name = "fcfs"

    def order(self, ready, *, hot=()):
        return sorted(ready, key=lambda r: (r.arrival_time, r.rid))


class SJFScheduler(Scheduler):
    name = "sjf"

    def order(self, ready, *, hot=()):
        return sorted(ready, key=lambda r: (r.job_size, r.arrival_time, r.rid))


class ExpertAffinityScheduler(Scheduler):
    """Greedy max-overlap chaining over predicted Top-C expert sets."""

    name = "expert-affinity"

    def __init__(self, top_c: int = 4):
        self.top_c = top_c

    def _set(self, req: ServeRequest) -> frozenset:
        # memoized on the request object itself (not rid): a scheduler
        # reused across workloads must never serve stale sets, and the
        # cache dies with the request
        cached = getattr(req, "_expert_set_memo", None)
        if cached is None or cached[0] != self.top_c:
            cached = (self.top_c, req.expert_set(self.top_c))
            req._expert_set_memo = cached
        return cached[1]

    def order(self, ready, *, hot=()):
        remaining = sorted(ready, key=lambda r: (r.arrival_time, r.rid))
        resident: set = set()
        for r in hot:
            resident |= self._set(r)
        out: List[ServeRequest] = []
        while remaining:
            if resident:
                # max overlap with the resident experts; FCFS tie-break
                best = max(
                    remaining,
                    key=lambda r: (len(self._set(r) & resident),
                                   -r.arrival_time, -r.rid),
                )
            else:  # cold start: seed the chain with the oldest request
                best = remaining[0]
            remaining.remove(best)
            out.append(best)
            resident |= self._set(best)
        return out


SCHEDULERS = {
    "fcfs": FCFSScheduler,
    "sjf": SJFScheduler,
    "expert-affinity": ExpertAffinityScheduler,
}


def get_scheduler(name: str, **kwargs) -> Scheduler:
    if name not in SCHEDULERS:
        raise KeyError(f"unknown scheduler {name!r}; options: {sorted(SCHEDULERS)}")
    return SCHEDULERS[name](**kwargs)
