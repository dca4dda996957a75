"""Token sampling (counterpart of ``repro/inference/sampling.py``): greedy
only. Temperature sampling draws from ``jax.random`` in the reference,
which torch cannot reproduce; it waits for its own slice."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int64 (the first maximum on a tie, as
    ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1)
