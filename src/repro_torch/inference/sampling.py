"""Token sampling (counterpart of ``repro/inference/sampling.py``): greedy
(paper Table 10) and temperature / top-k / top-p sampling.

The reference draws from ``jax.random``, which torch cannot reproduce, so
the draws here are the port's own: each row takes one uniform number from
an explicit CPU ``torch.Generator`` and picks its token by inverse CDF
over softmax(logits / T) on the logits' device. :func:`row_generator`
keys a row's generator by ``(seed, rid, step)`` alone, so a request's
draws never depend on its slot, its batch or the card. The top-k and
top-p masks are the reference's, operation for operation.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

NEG = -1e30


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int64 (the first maximum on a tie, as
    ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1)


def row_generator(seed: int, rid: int, step: int) -> torch.Generator:
    """The CPU generator of one draw: request ``rid``'s ``step``-th token
    under server seed ``seed`` (any non-negative ints; mixed through
    numpy's ``SeedSequence``, so nearby keys give unrelated streams)."""
    state = np.random.SeedSequence([int(seed), int(rid), int(step)]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def _uniforms(generators: Sequence[torch.Generator]) -> torch.Tensor:
    return torch.stack([torch.rand((), dtype=torch.float64, generator=g)
                        for g in generators])


def categorical(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """logits (B, ..., V) fp32, u (B,) uniforms in [0, 1) -> (B, ...) int64:
    the first token whose cumulative softmax mass exceeds ``u``. A token
    of zero mass (masked at ``NEG``) is never picked."""
    p = torch.softmax(logits.double(), dim=-1)
    cum = torch.cumsum(p, dim=-1)
    x = (u.to(cum).reshape(-1, *([1] * (cum.dim() - 1))) * cum[..., -1:])
    idx = torch.searchsorted(cum.contiguous(), x.contiguous(), right=True)
    return torch.clamp(idx, max=logits.shape[-1] - 1)[..., 0]


def sample_per_row(logits: torch.Tensor, temperatures,
                   generators: Sequence[torch.Generator]) -> torch.Tensor:
    """Per-row temperature sampling for heterogeneous batches.

    logits (B, 1, V); temperatures (B,) — rows with temperature <= 0 are
    decoded greedily (their generator is not drawn from), the rest sampled
    at their own temperature, each from its own generator (B of them, e.g.
    :func:`row_generator` per request and step). Returns (B, 1) int64."""
    t = np.asarray(temperatures, np.float32)
    hot = np.flatnonzero(t > 0)
    out = greedy(logits)
    if not len(hot):
        return out
    idx = torch.as_tensor(hot, device=logits.device)
    temps = torch.as_tensor(t[hot], device=logits.device)
    scaled = logits[idx].float() / temps[:, None, None]
    u = _uniforms([generators[i] for i in hot]).to(logits.device)
    out[idx] = categorical(scaled, u)
    return out


def sample(logits: torch.Tensor, generator: torch.Generator, *,
           temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int64: greedy at ``temperature`` <= 0, else
    a draw from softmax(l / T) after the reference's top-k and top-p masks;
    B uniforms from one ``generator``."""
    if temperature <= 0.0:
        return greedy(logits)
    l = sample_masks(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    u = _uniforms([generator] * l.shape[0]).to(logits.device)
    return categorical(l, u)


def sample_masks(logits: torch.Tensor, *, temperature: float, top_k: int = 0,
                 top_p: float = 0.0) -> torch.Tensor:
    """The scaled, masked logits that :func:`sample` draws from (fp32; a
    masked token at ``NEG``), as the reference computes them."""
    l = logits.float() / temperature
    if top_k:
        kth = torch.sort(l, dim=-1).values[..., -top_k][..., None]
        l = torch.where(l < kth, torch.full((), NEG, device=l.device), l)
    if top_p:
        sorted_l = torch.flip(torch.sort(l, dim=-1).values, dims=(-1,))
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        V = l.shape[-1]
        cutoff = torch.gather(sorted_l, -1, torch.clamp(cutoff_idx, max=V - 1))
        # the reference's gather past the end reads NaN, which masks nothing
        cutoff = torch.where(cutoff_idx < V, cutoff,
                             torch.full((), -float("inf"), device=l.device))
        l = torch.where(l < cutoff, torch.full((), NEG, device=l.device), l)
    return l
