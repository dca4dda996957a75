"""Rank-matching loss L_rm (paper Sec 3.1.1, App C.2), counterpart of
``repro/core/rank_match.py``.

    m^(t) = sum_{i,j} I{p_b,i > p_b,j} [rho - (p_f,i - p_f,j)]_+

Upper-bounds rho * Inv(p_f, p_b) (Lemma C.8), i.e. minimizing it
maximizes a lower bound on the Kendall rank correlation with the base
router. O(E^2) per token — evaluated in token chunks to bound memory.

The hinge is ``torch.maximum(rho - diff, 0)``: at a tie its gradient is
0.5, as ``jnp.maximum``'s is (``clamp(min=0)`` would give 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rank_match_token(pb: torch.Tensor, pf: torch.Tensor, rho: float) -> torch.Tensor:
    """pb, pf (..., E) -> m (...,): pairwise hinge count (Eq. 12)."""
    ind = (pb[..., :, None] > pb[..., None, :]).float()
    diff = pf[..., :, None] - pf[..., None, :]
    hinge = torch.maximum(rho - diff, torch.zeros((), dtype=diff.dtype, device=diff.device))
    return (ind * hinge).sum((-1, -2))


def inversion_count(pb: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """Kendall inversion count Inv(pf, pb) per token (Def C.7)."""
    ind_b = pb[..., :, None] > pb[..., None, :]
    ind_f = pf[..., :, None] < pf[..., None, :]
    return (ind_b & ind_f).sum((-1, -2))


def rank_match_loss(pb: torch.Tensor, pf: torch.Tensor, *, rho: float,
                    token_chunk: int = 128) -> torch.Tensor:
    """pb, pf (B, T, E) -> scalar mean over (B, T) of m^(t) (one layer).
    ``pb`` is detached; padded tokens contribute 0 (a constant pb row has
    no i > j pair)."""
    B, T, E = pf.shape
    pb = pb.detach().float()
    pf = pf.float()
    tc = min(token_chunk, T)
    nt = -(-T // tc)
    pad = nt * tc - T
    if pad:
        pb = F.pad(pb, (0, 0, 0, pad))
        pf = F.pad(pf, (0, 0, 0, pad))
    total = torch.zeros((), dtype=torch.float32, device=pf.device)
    for i in range(nt):
        sl = slice(i * tc, (i + 1) * tc)
        total = total + rank_match_token(pb[:, sl], pf[:, sl], rho).sum()
    return total / (B * T)
