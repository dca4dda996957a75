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


def next_token_shift(labels: torch.Tensor, prefix_len: int = 0):
    """(start, targets): logit position ``start + i`` predicts
    ``targets[:, i]``. Without a prefix each position predicts the next
    label; with ``prefix_len`` conditioning rows ahead of the tokens, the
    last prefix row predicts the first label."""
    if prefix_len:
        return prefix_len - 1, labels
    return 0, labels[:, 1:]


class _VocabSplitNLL(torch.autograd.Function):
    """:func:`vocab_parallel_nll` with its gradient ``(softmax - onehot) *
    g / N`` on the rank's own block, from the saved row max and sum: the
    backward makes no collective, so every rank's backward runs alike."""

    @staticmethod
    def forward(ctx, logits, targets, start: int, lo: int, group):
        import torch.distributed as dist

        x = logits[:, start:start + targets.shape[1]]
        mx = x.amax(-1)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        se = (x - mx[..., None]).exp_().sum(-1)
        dist.all_reduce(se, group=group)
        idx = targets.long() - lo
        mine = (idx >= 0) & (idx < x.shape[-1])
        idx = idx.clamp(0, x.shape[-1] - 1)[..., None]
        picked = torch.where(mine, x.gather(-1, idx)[..., 0], 0.0)
        dist.all_reduce(picked, group=group)
        log_se = se.log()
        ctx.save_for_backward(logits, idx, mine, mx, log_se)
        ctx.start = start
        # the reference's log_softmax, then the target's entry
        return -((picked - mx) - log_se).mean()

    @staticmethod
    def backward(ctx, g):
        logits, idx, mine, mx, log_se = ctx.saved_tensors
        n = mine.shape[1]
        grad = torch.zeros_like(logits)
        p = grad[:, ctx.start:ctx.start + n]
        p.copy_(logits[:, ctx.start:ctx.start + n]).sub_(mx[..., None]).sub_(
            log_se[..., None]).exp_()
        p.scatter_add_(-1, idx, -mine[..., None].to(p.dtype))
        return grad.mul_(g / mine.numel()), None, None, None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, *, lo: int, group,
                       start: int = 0) -> torch.Tensor:
    """The mean NLL of ``targets`` (B, T') over vocab-split logits, on local
    tensors: ``logits`` (B, T, V_local) fp32 holds this rank's columns [lo,
    lo + V_local) of the vocab, the other columns lie on the other ranks of
    ``group``; positions ``start`` to ``start + T'`` predict ``targets``
    (global ids). As XLA partitions the reference's ``nll_loss`` over a
    vocab split: the rows' max (an ``all_reduce`` MAX), their sum of
    ``exp(x - max)`` and the target's logit, taken on the rank that holds
    it (each an ``all_reduce`` SUM of (B, T') floats). No rank holds more
    than its own block; the result is the same on every rank of ``group``.
    The collectives are c10d's on plain tensors (as
    ``models.tensor_parallel``'s), which run on CUDA tensors over gloo."""
    return _VocabSplitNLL.apply(logits, targets, start, lo, group)


def nll_loss_on_mesh(logits, labels, prefix_len: int = 0):
    """The next-token NLL (:func:`next_token_shift`) of DTensor ``logits``
    (B, P + T, V) and ``labels`` (B, T), each rank on its own batch rows:
    the rows kept split as the logits split them, every other mesh dim
    replicated, except a split of the vocab, which stays split (over more
    than one mesh dim it raises). Split, each rank takes its own block
    (:func:`vocab_parallel_nll` over the mesh dim's group); whole, the
    plain :func:`nll_loss` on its rows, with no collective. The scalar is
    placed back as the mean of the ranks' means (a per-row vector of the
    local mean, sharded as the rows, averaged)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, vd = logits.device_mesh, logits.ndim - 1
    rows = tuple(p if p == Shard(0) else Replicate() for p in logits.placements)
    split = [i for i, p in enumerate(logits.placements)
             if p == Shard(vd) and mesh.shape[i] > 1]
    if len(split) > 1:
        raise NotImplementedError(f"the loss on logits whose vocab is split over mesh dims "
                                  f"{split}")
    pl = tuple(Shard(vd) if i in split else p for i, p in enumerate(rows))
    lg = logits.redistribute(mesh, pl).to_local()
    start, tgt = next_token_shift(labels.redistribute(mesh, rows).to_local(), prefix_len)
    if split:
        md, V = split[0], logits.shape[vd]
        lo = min(mesh.get_local_rank(md) * -(-V // mesh.shape[md]), V)  # torch.chunk's
        loss = vocab_parallel_nll(lg, tgt, lo=lo, group=mesh.get_group(md), start=start)
    else:
        loss = nll_loss(lg[:, start:start + tgt.shape[1]], tgt)
    return DTensor.from_local(loss.reshape(1).repeat(lg.shape[0]), mesh, rows,
                              run_check=False).mean()


def combine(nll, cs, rm, spec: MelinoeSpec):
    return nll + spec.lambda_cs * cs + spec.lambda_rm * rm
