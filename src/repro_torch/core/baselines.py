"""Functional analogues of the paper's comparison systems (Sec 4.2),
expressed as policies over the same OffloadedMoEEngine substrate so
throughput differences come from the *policy*, not implementation noise
(counterpart of ``repro/core/baselines.py``).

  static_lru / static_lfu — fixed-size cache, no fine-tune, no predictor
                            (Mixtral-Offloading-like, minus its 3-bit quant)
  stream_all              — no cache: every activation transfers
                            (DeepSpeed-MoE-inference-like lower bound)
  profile_prefetch        — k-means over past routing profiles; prefetch
                            nearest centroid (MoE-Infinity-like); as in the
                            reference, ``make_engine`` does not wire the
                            prefetcher in, so it runs as plain ``lfu``
  cpu_execute             — misses run on the host instead of transferring
                            (Fiddler-like): the reference's Eq.-3 cost model
                            (``host_executed``, ``host_time``); the experts
                            still compute on the device
  quant_cache             — INT4 residents -> larger effective C (FLoE/D.5)
  melinoe                 — fine-tuned checkpoint + predictor prefetch +
                            gamma/LFU cache (the paper's full system)

Composition (Table 5): pass the fine-tuned checkpoint to any baseline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..configs.base import ModelConfig
from .offload_engine import HardwareProfile, OffloadedMoEEngine


@dataclass
class BaselineSpec:
    name: str
    policy: str = "lfu"
    gamma: float = 0.9
    quantized: bool = False
    stream_all: bool = False
    cpu_execute: bool = False
    use_predictor: bool = False
    capacity_mult: float = 1.0  # quant_cache fits ~3x more experts


BASELINES = {
    "static_lru": BaselineSpec("static_lru", policy="lru"),
    "static_lfu": BaselineSpec("static_lfu", policy="lfu"),
    "stream_all": BaselineSpec("stream_all", stream_all=True),
    "profile_prefetch": BaselineSpec("profile_prefetch", policy="lfu"),
    "cpu_execute": BaselineSpec("cpu_execute", cpu_execute=True),
    "quant_cache": BaselineSpec("quant_cache", quantized=True, capacity_mult=3.0),
    "melinoe": BaselineSpec("melinoe", policy="gamma", use_predictor=True),
}


def make_engine(cfg: ModelConfig, params, spec: BaselineSpec, *, capacity: int,
                hw: HardwareProfile = HardwareProfile(), lora=None,
                lora_scale: float = 1.0, **engine_kw) -> OffloadedMoEEngine:
    """The engine of baseline ``spec`` at cache capacity
    ``min(E, max(1, int(capacity * spec.capacity_mult)))``. ``engine_kw``
    goes to the engine as it is (``device``, ``kernel_backend``,
    ``host_store``, ``quantized_experts``), so that the baselines of one
    config can share one pinned expert store."""
    E = cfg.moe_spec.num_experts
    return OffloadedMoEEngine(
        cfg,
        params,
        capacity=min(E, max(1, int(capacity * spec.capacity_mult))),
        policy=spec.policy,
        gamma=spec.gamma,
        quantized=spec.quantized,
        stream_all=spec.stream_all,
        cpu_execute=spec.cpu_execute,
        hw=hw,
        lora=lora,
        lora_scale=lora_scale,
        **engine_kw,
    )


# ---------------------------------------------------------------------------
# MoE-Infinity-like profile prefetcher: k-means over past per-sequence
# activation profiles; prefetch the centroid nearest to the running profile.
# ---------------------------------------------------------------------------


class ProfilePrefetcher:
    def __init__(self, n_clusters: int = 8, seed: int = 0):
        self.k = n_clusters
        self.seed = seed
        self.centroids: Optional[np.ndarray] = None  # (k, L*E)

    def fit(self, profiles: np.ndarray, iters: int = 25):
        """profiles (N, L, E) past per-sequence mean activations."""
        X = profiles.reshape(profiles.shape[0], -1).astype(np.float64)
        rng = np.random.default_rng(self.seed)
        k = min(self.k, X.shape[0])
        cent = X[rng.choice(X.shape[0], k, replace=False)]
        for _ in range(iters):
            d = ((X[:, None] - cent[None]) ** 2).sum(-1)
            assign = d.argmin(-1)
            for c in range(k):
                m = assign == c
                if m.any():
                    cent[c] = X[m].mean(0)
        self.centroids = cent
        self._shape = profiles.shape[1:]
        return self

    def predict_scores(self, partial_profile: np.ndarray) -> np.ndarray:
        """partial_profile (L, E) -> predicted (L, E) scores."""
        assert self.centroids is not None, "fit() first"
        x = partial_profile.reshape(-1)
        d = ((self.centroids - x[None]) ** 2).sum(-1)
        return self.centroids[d.argmin()].reshape(self._shape)
