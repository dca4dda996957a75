"""Combined MELINOE fine-tuning objective (Eq. 6), counterpart of
``repro/core/losses.py``:

    L = L_nll + lambda_cs * L_cs + lambda_rm * L_rm
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import MelinoeSpec
from .cache_sim import cache_sim_loss
from .rank_match import rank_match_loss


def melinoe_layer_losses(*, probs: torch.Tensor, moe_h: Optional[torch.Tensor],
                         base_router: Optional[torch.Tensor], spec: MelinoeSpec,
                         cache_capacity: int, top_k: int):
    """Per-layer (cs, rm) contributions, each a scalar mean over (B, T).
    probs (B, T, E) the fine-tuned router distribution; moe_h (B, T, d)
    the hidden states fed to the router; base_router (d, E) the frozen
    base router. On DTensors (a sharded mesh) each rank takes its own
    batch rows (``models.runtime.on_rows``)."""
    from ..models.runtime import is_distributed, on_rows

    if is_distributed(probs):
        if is_distributed(base_router):
            base_router = base_router.full_tensor()
        return on_rows(lambda p, h: melinoe_layer_losses(
            probs=p, moe_h=h, base_router=base_router, spec=spec,
            cache_capacity=cache_capacity, top_k=top_k), probs, moe_h)
    cs = cache_sim_loss(probs, top_k=top_k, gamma=spec.gamma,
                        cache_capacity=cache_capacity, request_mode=spec.request_mode,
                        impl=getattr(spec, "cs_impl", "scan"))
    rm = torch.zeros((), dtype=torch.float32, device=probs.device)
    if base_router is not None and moe_h is not None:
        # same_trajectory mode: the frozen base router on the fine-tuned
        # model's (detached) hidden states
        h = moe_h.detach().float()
        pb = torch.softmax(h @ base_router.detach().float(), dim=-1)
        rm = rank_match_loss(pb, probs, rho=spec.rho, token_chunk=spec.rm_token_chunk)
    return cs, rm


def nll_loss(logits: torch.Tensor, targets: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard LM NLL. logits (B, T, V), targets (B, T) integer."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def combine(nll, cs, rm, spec: MelinoeSpec):
    return nll + spec.lambda_cs * cs + spec.lambda_rm * rm
