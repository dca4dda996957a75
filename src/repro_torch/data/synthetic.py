"""Synthetic cluster-preference LM corpus.

Dolly15K / GSM8K are unavailable offline, so the paper's premise is
engineered directly into the data (DESIGN.md Sec 10): sequences are
drawn from latent *clusters*, each with its own token distribution and
phrase bank. A base MoE trained on this corpus develops weak
per-sequence expert preferences (clusters route differently), which is
exactly the structure MELINOE's fine-tuning amplifies — mirroring the
paper's Fig 1b observation on OLMoE.

Deterministic, seeded, infinite; batches shard over the mesh data axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class SyntheticConfig:
    vocab: int = 4096
    n_clusters: int = 8
    seq_len: int = 128
    cluster_vocab_frac: float = 0.22  # token budget each cluster prefers
    phrase_len: int = 8
    n_phrases: int = 64  # learnable n-gram structure per cluster
    phrase_prob: float = 0.6
    seed: int = 0


class ClusterLM:
    """Markov-ish generator: cluster-specific unigram pools + phrase bank."""

    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, K = cfg.vocab, cfg.n_clusters
        nv = max(int(V * cfg.cluster_vocab_frac), 16)
        self.pools = np.stack([rng.choice(V, nv, replace=False) for _ in range(K)])
        self.phrases = rng.integers(
            0, V, (K, cfg.n_phrases, cfg.phrase_len), dtype=np.int64
        )
        for k in range(K):  # phrases drawn from the cluster pool
            self.phrases[k] = self.pools[k][
                rng.integers(0, nv, (cfg.n_phrases, cfg.phrase_len))
            ]

    def sample_sequence(self, rng: np.random.Generator,
                        cluster: Optional[int] = None) -> Tuple[np.ndarray, int]:
        cfg = self.cfg
        k = int(rng.integers(cfg.n_clusters)) if cluster is None else cluster
        out = np.empty(cfg.seq_len, np.int64)
        i = 0
        while i < cfg.seq_len:
            if rng.random() < cfg.phrase_prob:
                ph = self.phrases[k][rng.integers(cfg.n_phrases)]
                n = min(len(ph), cfg.seq_len - i)
                out[i : i + n] = ph[:n]
                i += n
            else:
                out[i] = self.pools[k][rng.integers(self.pools.shape[1])]
                i += 1
        return out, k

    def batches(self, batch_size: int, *, seed: int = 1,
                with_cluster: bool = False) -> Iterator:
        rng = np.random.default_rng(seed)
        while True:
            toks = np.empty((batch_size, self.cfg.seq_len), np.int64)
            ks = np.empty((batch_size,), np.int64)
            for b in range(batch_size):
                toks[b], ks[b] = self.sample_sequence(rng)
            batch = {
                "tokens": toks.astype(np.int32),
                "labels": toks.astype(np.int32),
            }
            if with_cluster:
                batch["cluster"] = ks
            yield batch


def eval_batches(lm: ClusterLM, n: int, batch_size: int, *, seed: int = 999):
    """Deterministic held-out split."""
    it = lm.batches(batch_size, seed=seed, with_cluster=True)
    return [next(it) for _ in range(n)]
