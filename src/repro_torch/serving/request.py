"""Serving request/result types shared by every scheduler and server (a
numpy-only copy of ``repro/serving/request.py``).

A ``ServeRequest`` extends the static-batch ``inference.engine.Request``
with the fields a continuous-batching server needs: an identity, an
arrival time on the (virtual) serving clock, per-request stop tokens,
and the optional predictor-scored expert preferences that the
expert-affinity scheduler groups on (paper Sec 3.1.2 / Eq. 7).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(eq=False)  # identity semantics: the ndarray prompt makes the
class ServeRequest:   # generated __eq__ crash in list.remove / comparisons
    rid: int
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    stop_tokens: Tuple[int, ...] = ()
    arrival_time: float = 0.0
    cluster: Optional[int] = None  # latent workload cluster (telemetry only)
    expert_scores: Optional[np.ndarray] = None  # (L, E) predictor scores
    # SLO: virtual seconds after arrival by which the request must finish;
    # None = best effort (never shed, never deadline-retired)
    slo: Optional[float] = None
    # quality-vs-latency dial for the little-expert degraded mode:
    # fraction of cache misses served by the big (exact) expert. 1.0 =
    # always exact; 0.0 = always the low-rank distillate. Only honored
    # by engines built with a little bank.
    quality: float = 1.0
    # crash-recovery watermark: tokens this request had already emitted
    # before the process died (journal replay sets it). A server admits
    # a resumed request by prefilling concat(prompt, resumed) — greedy
    # decode depends only on the token prefix, so generation continues
    # token-identically — and counts them against max_new_tokens.
    resumed: Optional[np.ndarray] = None  # (n,) int32 or None

    @property
    def n_resumed(self) -> int:
        return 0 if self.resumed is None else int(len(self.resumed))

    @property
    def deadline(self) -> Optional[float]:
        """Absolute virtual-clock deadline, or None when best-effort."""
        return None if self.slo is None else self.arrival_time + self.slo

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def job_size(self) -> int:
        """Total token work estimate (prefill + decode budget)."""
        return self.prompt_len + int(self.max_new_tokens)

    def expert_set(self, top_c: int) -> frozenset:
        """Predicted Top-C expert ids per layer as {(layer, expert)} —
        the overlap currency of the affinity scheduler. Empty set when
        the request carries no scores."""
        if self.expert_scores is None:
            return frozenset()
        top = np.argsort(-np.asarray(self.expert_scores), axis=-1)[:, :top_c]
        return frozenset(
            (int(l), int(e)) for l in range(top.shape[0]) for e in top[l]
        )


@dataclass(eq=False)  # same: tokens is an ndarray
class ServeResult:
    rid: int
    tokens: np.ndarray  # (<= max_new_tokens,) int32 generated tokens
    # "stop" | "length" | "deadline" (cut mid-decode at the SLO) |
    # "shed" (never admitted: queue bound or expired while waiting)
    finish_reason: str
    arrival_time: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0
    decode_steps: int = 0  # batch decode iterations this request was live for
    degraded: bool = False  # served >=1 little-expert substitution

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def queue_delay(self) -> float:
        return self.start_time - self.arrival_time
