"""Host-side expert cache policies (Def C.1) and the per-layer cache
manager used by the offloaded inference engine.

Policies
--------
* ``lru``   — evict least-recently-used (gamma -> 0 limit)
* ``lfu``   — evict least-frequently-used (gamma = 1 limit)
* ``gamma`` — Def C.1: gamma-discounted request counts; the cache is the
              Top-C of the counts; lazy updates (Remark C.2).

The manager counts misses == host->device transfers (Eq. 3).

A numpy copy of ``repro/core/expert_cache.py``: the same policies, trace
instants (``cache.access``, ``cache.prefill``), durable state and audit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence

import numpy as np

from ..obs.trace import get_tracer


class LayerExpertCache:
    """Cache of expert ids for one MoE layer, capacity C."""

    def __init__(self, num_experts: int, capacity: int, policy: str = "lfu",
                 gamma: float = 0.9, layer_id: int = -1):
        assert 0 < capacity <= num_experts
        self.E = num_experts
        self.C = capacity
        self.policy = policy
        self.gamma = gamma
        self.layer_id = layer_id
        self.counts = np.zeros(num_experts, np.float64)  # lfu / gamma
        self.last_used = np.full(num_experts, -1, np.int64)  # lru
        self.resident: set[int] = set()
        self.step = 0
        self.misses = 0
        self.hits = 0
        self.evictions = 0
        # suppresses per-token trace instants while a batched entry point
        # aggregates them into one event
        self._nested = False

    def _traced(self, name: str, fn, *args):
        """Run ``fn`` and emit one aggregated hit/miss/evict instant."""
        h0, m0, v0 = self.hits, self.misses, self.evictions
        self._nested = True
        try:
            out = fn(*args)
        finally:
            self._nested = False
        get_tracer().instant(name, layer=self.layer_id,
                             hits=self.hits - h0, misses=self.misses - m0,
                             evictions=self.evictions - v0)
        return out

    # -- setup ------------------------------------------------------------
    def prefill(self, expert_ids: Iterable[int]) -> int:
        if get_tracer().enabled and not self._nested:
            return self._traced("cache.prefill", self._prefill, expert_ids)
        return self._prefill(expert_ids)

    def _prefill(self, expert_ids: Iterable[int]) -> int:
        """Proactively load experts (predictor prefetch). Returns #loaded.

        Evicts as needed so residency never exceeds capacity C, even when
        the cache is already warm; the incoming prefetch set is protected
        from its own evictions."""
        wanted = [int(e) for e in list(expert_ids)[: self.C]]
        protect = set(wanted)
        loaded = 0
        for e in wanted:
            if e in self.resident:
                continue
            while len(self.resident) >= self.C:
                victim = self._evict_candidate(protect)
                self.resident.discard(victim)
                self.evictions += 1
            self.resident.add(e)
            loaded += 1
        # prefetched experts get a count/recency credit so they are not
        # instantly evicted (only the wanted set: crediting every resident
        # would re-inflate stale LFU counts and distort eviction order)
        for e in wanted:
            self.counts[e] = max(self.counts[e], 1.0)
            self.last_used[e] = self.step
        return loaded

    # -- durable state (recovery checkpoints) -------------------------------
    def state(self) -> dict:
        """Snapshot of the policy scores + resident set — what a warm
        revival needs to rebuild eviction order AND physical residency."""
        return {
            "resident": sorted(int(e) for e in self.resident),
            "counts": self.counts.copy(),
            "last_used": self.last_used.copy(),
            "step": self.step,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

    def load_state(self, state: dict, *, resident: bool = True) -> None:
        """Restore a :meth:`state` snapshot. ``resident=False`` restores
        only the policy scores/stats (cold restart keeps the accounting
        but pays the demand misses again)."""
        self.counts = np.asarray(state["counts"], np.float64).copy()
        self.last_used = np.asarray(state["last_used"], np.int64).copy()
        self.step = int(state["step"])
        self.hits = int(state["hits"])
        self.misses = int(state["misses"])
        self.evictions = int(state["evictions"])
        self.resident = set(int(e) for e in state["resident"]) if resident \
            else set()

    def audit(self) -> List[str]:
        """Internal-consistency check (watchdog contract). Returns
        violation strings, empty when healthy."""
        v = []
        if len(self.resident) > self.C:
            v.append(f"resident {len(self.resident)} > capacity {self.C}")
        bad = [e for e in self.resident if not (0 <= e < self.E)]
        if bad:
            v.append(f"resident ids out of range: {sorted(bad)}")
        if not np.all(np.isfinite(self.counts)) or np.any(self.counts < 0):
            v.append("policy counts non-finite or negative")
        if min(self.hits, self.misses, self.evictions) < 0:
            v.append(f"negative stats: hits={self.hits} misses={self.misses} "
                     f"evictions={self.evictions}")
        return v

    # -- per-token access ---------------------------------------------------
    def _evict_candidate(self, protect: set) -> int:
        if len(self.resident) <= 64:  # typical C: python min beats numpy
            free = [e for e in self.resident if e not in protect] or list(
                self.resident)
            key = self.last_used if self.policy == "lru" else self.counts
            return min(free, key=key.__getitem__)
        res = np.fromiter(self.resident, int)
        free = res[~np.isin(res, list(protect))] if protect else res
        if free.size == 0:
            free = res  # degenerate: everything protected
        if self.policy == "lru":
            return int(free[np.argmin(self.last_used[free])])
        return int(free[np.argmin(self.counts[free])])  # lfu / gamma

    def access(self, requested: Sequence[int]) -> List[int]:
        """One token's Top-K expert request. Returns the list of MISSED
        expert ids (each miss = one transfer)."""
        if get_tracer().enabled and not self._nested:
            return self._traced("cache.access", self._access, requested)
        return self._access(requested)

    def _access(self, requested: Sequence[int]) -> List[int]:
        self.step += 1
        requested = [int(e) for e in requested]
        if self.policy == "gamma":
            self.counts *= self.gamma
        missed = []
        protect = set(requested)
        for e in requested:
            if e in self.resident:
                self.hits += 1
            else:
                missed.append(e)
                self.misses += 1
                while len(self.resident) >= self.C:
                    victim = self._evict_candidate(protect)
                    self.resident.discard(victim)
                    self.evictions += 1
                self.resident.add(e)
            self.counts[e] += 1.0
            self.last_used[e] = self.step
        return missed

    def access_batch(self, requests) -> List[int]:
        """Batched token accesses: ``requests`` (N, K) int expert ids, in
        token order. Metrics-equivalent to N sequential :meth:`access`
        calls — identical hits/misses/evictions, resident set, counts and
        recency — but the all-hit spans (the common warm-cache case) are
        processed in vectorized numpy instead of per-token Python.

        Returns the concatenated missed-expert list (token order, with
        duplicates when an expert is missed, evicted, and missed again
        inside the same batch) — each entry is one host->device transfer.
        """
        if get_tracer().enabled and not self._nested:
            return self._traced("cache.access", self._access_batch, requests)
        return self._access_batch(requests)

    def _access_batch(self, requests) -> List[int]:
        req = np.asarray(requests, dtype=np.int64)
        if req.ndim == 1:
            req = req[None]
        N, K = req.shape
        if N == 1:  # decode batches of one: the sequential step IS the batch
            return self.access(req[0])
        missed: List[int] = []
        rows = req.tolist()  # python-set membership beats np.isin per row
        n = 0
        while n < N:
            # leading hit span: no eviction can trigger before the first
            # non-hit token, so the resident set is constant across it —
            # detect in O(span * K), bookkeep vectorized
            res = self.resident
            m = n
            while m < N and all(e in res for e in rows[m]):
                m += 1
            if m > n:
                self._hit_span(req[n:m])
                n = m
            if n < N:  # first token with a miss: exact sequential step
                missed.extend(self.access(req[n]))
                n += 1
        return missed

    def _hit_span(self, req: np.ndarray) -> None:
        """Bookkeeping for a span of tokens whose requests all hit. Bit-
        identical to the sequential loop: per token the gamma decay is one
        whole-array multiply and each request adds 1.0 once."""
        n, K = req.shape
        self.hits += n * K
        if self.policy == "gamma":
            for t in range(n):  # keep the sequential decay/add FP order
                self.counts *= self.gamma
                np.add.at(self.counts, req[t], 1.0)
        else:
            np.add.at(self.counts, req.reshape(-1), 1.0)
        steps = np.repeat(self.step + 1 + np.arange(n, dtype=np.int64), K)
        np.maximum.at(self.last_used, req.reshape(-1), steps)
        self.step += n


@dataclass
class CacheStats:
    misses: int
    hits: int
    evictions: int

    @property
    def transfers(self) -> int:
        return self.misses

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0


class ModelExpertCache:
    """One LayerExpertCache per MoE layer."""

    def __init__(self, n_layers: int, num_experts: int, capacity: int,
                 policy: str = "lfu", gamma: float = 0.9):
        self.layers = [
            LayerExpertCache(num_experts, capacity, policy, gamma, layer_id=l)
            for l in range(n_layers)
        ]

    def prefill_from_scores(self, scores: np.ndarray) -> int:
        """scores (L, E) predictor output -> preload Top-C per layer."""
        loaded = 0
        for l, cache in enumerate(self.layers):
            top = np.argsort(-scores[l])[: cache.C]
            loaded += cache.prefill(top)
        return loaded

    def access(self, layer: int, requested: Sequence[int]) -> List[int]:
        return self.layers[layer].access(requested)

    def access_batch(self, layer: int, requests) -> List[int]:
        return self.layers[layer].access_batch(requests)

    def stats(self) -> CacheStats:
        return CacheStats(
            misses=sum(c.misses for c in self.layers),
            hits=sum(c.hits for c in self.layers),
            evictions=sum(c.evictions for c in self.layers),
        )

    def transfers_per_layer(self) -> float:
        return float(np.mean([c.misses for c in self.layers]))

    def reset_stats(self):
        for c in self.layers:
            c.misses = c.hits = c.evictions = 0

    def state(self) -> List[dict]:
        """Per-layer :meth:`LayerExpertCache.state` snapshots."""
        return [c.state() for c in self.layers]

    def load_state(self, states: Sequence[dict], *, resident: bool = True) -> None:
        assert len(states) == len(self.layers), (len(states), len(self.layers))
        for c, st in zip(self.layers, states):
            c.load_state(st, resident=resident)

    def audit(self) -> List[str]:
        return [f"layer {c.layer_id}: {msg}"
                for c in self.layers for msg in c.audit()]

    def publish(self, registry=None, **labels) -> None:
        """Export per-layer and aggregate hit/miss/evict gauges onto a
        :class:`~repro.obs.registry.MetricsRegistry` (global by default)."""
        if registry is None:
            from ..obs.registry import REGISTRY as registry
        for c in self.layers:
            for nm, v in (("cache_hits", c.hits), ("cache_misses", c.misses),
                          ("cache_evictions", c.evictions)):
                registry.gauge(nm, "expert cache events",
                               layer=c.layer_id, **labels).set(v)
        s = self.stats()
        registry.gauge("cache_hit_rate", "aggregate expert cache hit rate",
                       **labels).set(s.hit_rate)

